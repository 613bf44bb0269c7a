"""Whole runs of the harness on the CPU at the cut size of conftest.shrink:
the result line, a cell added as a file alone, and `correct` coming out
false with the timed path broken underneath. The control's readings need
the card (TF32 does not exist on the CPU)."""
import json
import os

import pytest
import torch

from qmbench import calibrate, harness

SEED = 2 ** 31 + 101
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace=False, seconds=0.5):
    return harness.run_cell(root, cell, SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("cell,trace", [("fleet_mpc.trot.b4096", False),
                                        ("fleet_mpc.trot.b4096", True),
                                        ("hw_inline.stance", False),
                                        ("hw_inline.stance", True)])
def test_last_line_has_the_contract_keys(small_bench, capsys, cell, trace):
    r = _run(small_bench, cell, trace)
    harness.report(r)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == CONTRACT and keys[-1] == "checks"
    assert set(keys) - set(CONTRACT) <= {"breakdown", "samples", "checks"}
    assert ("breakdown" in keys) == trace
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    with open(os.path.join(small_bench, "workloads", f"{cell}.json")) as fh:
        wl = json.load(fh)
    want = set(wl["per_layer"]) if trace else set(wl["end_to_end"]) | {
        "setup_s"}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_as_a_file_runs_without_an_edit(small_bench, tmp_path):
    import shutil
    root = str(tmp_path / "qmbench")
    shutil.copytree(small_bench, root)
    before = {f: open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(root) for f in fs}
    with open(os.path.join(root, "workloads",
                           "fleet_mpc.trot.b4096.json")) as fh:
        wl = json.load(fh)
    wl["traffic"]["batch"] = 3
    wl["why"] = "a throwaway cell of three scenarios"
    with open(os.path.join(root, "workloads", "fleet_mpc.trot.b3.json"),
              "w") as fh:
        json.dump(wl, fh)
    r = _run(root, "fleet_mpc.trot.b3")
    assert r["correct"] and r["attempted"] % 3 == 0
    after = {f: open(os.path.join(d, f), "rb").read()
             for d, _, fs in os.walk(root) for f in fs
             if f != "fleet_mpc.trot.b3.json"}
    assert {k: v for k, v in after.items() if k in before} == {
        k: v for k, v in before.items() if k in after}


# -- faults planted under the timed path: `correct` has to come out false --

def _fleet_fault(kind):
    import qm_control_tpu_torch.parallel as P
    real = P.make_batched_mpc_step

    def make(*a, **k):
        step = real(*a, **k)

        def broken(batch):
            new, pol = step(batch)
            if kind == "unchanged":         # the warm start is not carried
                return batch, pol
            if kind == "half":              # half the fleet left out
                B = batch.x.shape[0]
                h = B // 2
                sub = type(batch)(*[
                    type(f)(*[a[:h] for a in f]) if isinstance(f, tuple)
                    else f[:h] for f in batch])
                _, p = step(sub)
                pol = type(pol)(*[torch.cat([a, a.float().mean(
                    0, keepdim=True).expand(B - h, *a.shape[1:]).to(a.dtype)])
                    for a in p])
                return new._replace(W_warm=pol.W, X_warm=pol.X), pol
            if kind == "altered":           # an answer changed
                pol = pol._replace(W=pol.W * 1.01)
                return new._replace(W_warm=pol.W), pol
            raise ValueError(kind)
        return broken
    return make


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fleet_fault_is_not_correct(small_bench, monkeypatch, kind):
    import qm_control_tpu_torch.parallel as P
    monkeypatch.setattr(P, "make_batched_mpc_step", _fleet_fault(kind))
    r = _run(small_bench, "fleet_mpc.trot.b4096", seconds=1.0)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_hw_fault_is_not_correct(small_bench, monkeypatch, kind):
    from qm_control_tpu_torch.runtime import hw
    from qm_control_tpu_torch.wbc import wbc
    if kind == "unchanged":               # the plant never steps
        monkeypatch.setattr(hw.SimHardware, "write", lambda self, cmd: None)
    else:                                 # a torque changed by 5 Nm
        real = wbc.HierarchicalWbc.update

        def update(self, *a, **k):
            res = real(self, *a, **k)
            return res._replace(torques=res.torques + torch.tensor(
                [5.0] + [0.0] * 17, device=res.torques.device))
        monkeypatch.setattr(wbc.HierarchicalWbc, "update", update)
    r = _run(small_bench, "hw_inline.stance", seconds=1.0)
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fleet_mpc.trot.b4096",
                                  "hw_inline.stance"])
def test_control_is_not_correct(small_bench, cell):
    """The reference with TF32 products in the port's place fails a limit
    (on the card; the full-size readings are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("the control is TF32 arithmetic: it needs the card")
    with open(os.path.join(small_bench, "workloads", f"{cell}.json")) as fh:
        limits = json.load(fh)["check"]["limits"]
    got, _ = calibrate.readings(cell, SEED, 0.0, True, "cuda",
                                small_bench)
    assert any(not got[k] <= v for k, v in limits.items()), got
