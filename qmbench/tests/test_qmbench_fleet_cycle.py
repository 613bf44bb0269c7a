"""The closed-loop fleet's cell on the CPU at the cut size of
conftest.shrink (horizon 0.12 s of 0.04 s nodes), cut further to B = 2
and one traced period: on CPU tensors K1's plain version solves each
scenario's cascade op by op, so a traced period at B = 1 is ~2.8 million
profiler events (~5 GB). The result line traced and untraced, `correct`
false under each fault planted in the timed path, and the cell's readers
over a traced run."""
import json
import os
import shutil

import pytest
import torch

from qmbench import harness

SEED = 2 ** 31 + 303
CELL = "fleet_cycle.trot.b256"
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
HOST_READERS = ("loop.tick_ms.cycle", "mpc.solve_ms.cycle")
DEVICE_READERS = ("loop.tick_dev_ms.cycle", "k1.roofline_pct.cycle",
                  "device_idle_pct.cycle")


def _run(root, trace=False):
    return harness.run_cell(root, CELL, SEED, 0.5, trace, device="cpu")


@pytest.fixture(scope="module")
def bench(small_bench, tmp_path_factory):
    """A copy of the cut benchmark with this cell at B = 2, one traced
    period."""
    root = str(tmp_path_factory.mktemp("cycle") / "qmbench")
    shutil.copytree(small_bench, root)
    path = os.path.join(root, "workloads", f"{CELL}.json")
    with open(path) as fh:
        wl = json.load(fh)
    wl["traffic"]["batch"] = 2
    wl["trace_steps"] = 1
    with open(path, "w") as fh:
        json.dump(wl, fh)
    return root


@pytest.fixture(scope="module")
def traced(bench):
    return _run(bench, True)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contract_keys(bench, traced, capsys, trace):
    r = traced if trace else _run(bench)
    harness.report(r)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["attempted"] % 2 == 0
    want = set(HOST_READERS) if trace else {"mpc_solves_per_s", "setup_s"}
    assert set(line["metrics"]) == want
    assert set(line["checks"]) == {"cost_rel", "X_gap", "tau_gap", "q_gap",
                                   "v_gap"}


def test_readers_read_a_traced_run(bench, traced):
    """The host readers read the port's ranges; the device readers find no
    device in a CPU trace and return nothing."""
    wl, cfg, _ = harness.find_cell(bench, CELL)
    assert set(wl["per_layer"]) == set(HOST_READERS) | set(DEVICE_READERS)
    for name in HOST_READERS:
        assert traced["metrics"][name]["value"] > 0
        assert traced["metrics"][name]["unit"] == "ms"
    for name in DEVICE_READERS:
        assert name not in traced["metrics"]


def _plant(monkeypatch, kind):
    import qm_control_tpu_torch.parallel as P
    from qm_control_tpu_torch.runtime import loop as L
    if kind == "lag0":              # the ticks execute the fresh policy
        real = P.make_batched_cycle

        def make(model, info, cfg, loop_cfg=None, **k):
            return real(model, info, cfg,
                        loop_cfg._replace(mrt_policy_lag=0), **k)
        monkeypatch.setattr(P, "make_batched_cycle", make)
    elif kind == "substep":         # a second plant step per tick
        monkeypatch.setattr(L.LoopConfig, "substeps_per_tick",
                            property(lambda self: 2))
    else:                           # a torque changed by 2 Nm
        real = L.hierarchical_wbc_update

        def update(*a, **k):
            res = real(*a, **k)
            return res._replace(torques=res.torques + torch.tensor(
                [2.0] + [0.0] * 17))
        monkeypatch.setattr(L, "hierarchical_wbc_update", update)


@pytest.mark.parametrize("kind", ["lag0", "substep", "offset"])
def test_fault_is_not_correct(bench, monkeypatch, kind):
    _plant(monkeypatch, kind)
    r = _run(bench)
    assert r["correct"] is False, r["checks"]
