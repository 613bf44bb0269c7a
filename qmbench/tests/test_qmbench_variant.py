"""The MPC-only controller's cell on the CPU at the cut size of
conftest.shrink (horizon 0.12 s of 0.04 s nodes), the robot, the MPC-only
stack and the 500 Hz ticks whole, 2 starting solves: the result line
traced and untraced, the cell's readers over a traced run, `correct`
false under each fault planted in the timed path, and the frozen count
against its roofline reader."""
import json
import os
import shutil

import pytest
import torch

from qmbench import harness, trace
from qmbench.counts.hoqp import hoqp_bound_s

SEED = 2 ** 31 + 505
CELL = "variant.stance.500hz"
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
HOST_READERS = ("wbc.cascade_ms.variant", "mpc.solve_ms.cycle")
DEVICE_READERS = ("hoqp.launches_per_level.variant",
                  "hoqp.roofline_pct.variant", "device_idle_pct.cycle")


def _run(root, trace=False, seconds=1.0):
    return harness.run_cell(root, CELL, SEED, seconds, trace, device="cpu")


@pytest.fixture(scope="module")
def bench(small_bench, tmp_path_factory):
    """A copy of the cut benchmark with this cell at 2 starting solves,
    2 warm-up periods and one traced period."""
    root = str(tmp_path_factory.mktemp("variant") / "qmbench")
    shutil.copytree(small_bench, root)
    path = os.path.join(root, "workloads", f"{CELL}.json")
    with open(path) as fh:
        wl = json.load(fh)
    wl["traffic"]["warmup_solves"] = 2
    wl["warmup_steps"] = 2
    wl["trace_steps"] = 1
    wl["check"]["workers"] = 1
    with open(path, "w") as fh:
        json.dump(wl, fh)
    return root


@pytest.fixture(scope="module")
def traced(bench):
    return _run(bench, True)


@pytest.mark.parametrize("trace_on", [False, True])
def test_last_line_has_the_contract_keys(bench, traced, capsys, trace_on):
    r = traced if trace_on else _run(bench)
    harness.report(r)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    assert ("breakdown" in keys) == trace_on
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = set(HOST_READERS) if trace_on else {"mpc_solves_per_s",
                                               "setup_s"}
    assert set(line["metrics"]) == want
    assert set(line["checks"]) == {"cost_rel", "X_gap", "arm_cmd_gap",
                                   "tau_gap", "q_gap", "v_gap", "level_gap"}


def test_readers_read_a_traced_run(bench, traced):
    """The host readers read the port's ranges; the device readers find no
    device in a CPU trace and return nothing."""
    wl, _, _ = harness.find_cell(bench, CELL)
    assert set(wl["per_layer"]) == set(HOST_READERS) | set(DEVICE_READERS)
    for name in HOST_READERS:
        assert traced["metrics"][name]["value"] > 0
        assert traced["metrics"][name]["unit"] == "ms"
    for name in DEVICE_READERS:
        assert name not in traced["metrics"]


def _plant(monkeypatch, kind):
    from qm_control_tpu_torch.runtime import mpc_loop as ML
    from qm_control_tpu_torch.wbc import hoqp as H
    from qm_control_tpu_torch.wbc import wbc as W
    if kind == "drop_level":        # the cascade's last level dropped
        monkeypatch.setattr(W, "_pivoted",
                            lambda t0, t1, t2: H.hoqp_solve([t0, t1]))
    else:                           # a leg torque changed by 2 Nm
        real = ML.push_command

        def offset(plant, cmd):
            return real(plant, cmd._replace(ff=cmd.ff + torch.tensor(
                [2.0] + [0.0] * 17)))
        monkeypatch.setattr(ML, "push_command", offset)


@pytest.mark.parametrize("kind", ["drop_level", "offset"])
def test_fault_is_not_correct(bench, monkeypatch, kind):
    _plant(monkeypatch, kind)
    r = _run(bench)
    assert r["correct"] is False, r["checks"]


def test_roofline_reader_counts_cascades_by_levels(bench):
    """hoqp.roofline_pct.variant on a made-up trace: two cascades (six
    hoqp.level ranges) under two wbc.cascade ranges whose launches took 1
    ms of device time in all."""
    E = trace.Event
    W = E(trace.WINDOW, False, True, 0, 10 ** 7, 1, 1, 0)
    ev = [W]
    corr = 10
    for c in range(2):
        a = 1000 + c * 4 * 10 ** 6
        ev.append(E("wbc.cascade", False, True, a, a + 3 * 10 ** 6, 1,
                    corr, 0))
        corr += 1
        for lv in range(3):
            s = a + 10 + lv * 10 ** 6
            ev.append(E("hoqp.level", False, True, s, s + 900000, 1, corr,
                        0))
            ev.append(E("aten::mm", False, False, s + 5, s + 50, 1,
                        corr + 100, 0))
            if lv == 0:
                ev.append(E("gemm", True, False, s + 60, s + 60 + 500000,
                            7, 0, corr + 100))
            corr += 1
    tr = trace.build(ev, 1)
    cfg = harness.load_json(os.path.join(bench, "configs",
                                         "robot_variant_stance.json"))
    ctx = harness.Context(tr, [], None, cfg, bench)
    got = harness.reader(bench, "hoqp.roofline_pct.variant").read(ctx)
    want = 100.0 * 2 * hoqp_bound_s(cfg["wbc_stack"]) / 1e-3
    assert got == pytest.approx(want)
    per_level = harness.reader(bench, "hoqp.launches_per_level.variant")
    assert per_level.read(ctx) == pytest.approx(2 / 6)
