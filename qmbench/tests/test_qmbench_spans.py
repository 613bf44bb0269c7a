"""qmbench/spans.py on hand-built traces, and the stage readers over whole
traced runs of each cell on the CPU (a copy of the cut benchmark whose
cells list the readers; the benchmark's own cells are not edited)."""
import json
import os
import shutil

import pytest

from qmbench import harness, spans as S, trace as T

SEED = 2 ** 31 + 202
W = T.Event(T.WINDOW, False, True, 0, 1000, 1, 0, 0)
READERS = {
    "hw_inline.stance": ["hw.estimate_ms.robot", "mpc.solve_ms.robot",
                         "wbc.data_ms.robot", "wbc.cascade_ms.robot",
                         "plant.step_ms.robot", "launches_per_tick.robot"],
    "fleet_mpc.trot.b4096": ["mpc.solve_self_ms.fleet",
                             "sqp.line_search_ms.fleet",
                             "sqp.linearize_dev_ms.fleet",
                             "sqp.riccati_dev_ms.fleet",
                             "sqp.line_search_dev_ms.fleet",
                             "launches_per_step.fleet"],
}
DEVICE_ONLY = {"launches_per_tick.robot", "sqp.linearize_dev_ms.fleet",
               "sqp.riccati_dev_ms.fleet", "sqp.line_search_dev_ms.fleet",
               "launches_per_step.fleet"}


def _ann(name, a, b, thread=1, corr=0):
    return T.Event(name, False, True, a, b, thread, corr, 0)


def _op(corr, a, b, thread=1):
    return T.Event("aten::mul", False, False, a, b, thread, corr, 0)


def _kernel(linked, a, b):
    return T.Event("kernel", True, False, a, b, 7, 0, linked)


def test_a_range_and_its_device_side_copy_count_once():
    """Kineto's copy of a range on the device timeline has the range's
    name, correlation id and thread id, and starts later; a range of
    another thread is not the window's."""
    tr = T.build([W, _ann("sqp.linearize", 100, 200, corr=5),
                  _ann("sqp.linearize", 120, 230, corr=5),
                  _ann("sqp.linearize", 300, 400, corr=9),
                  _ann("sqp.linearize", 500, 600, thread=2, corr=11)], 1)
    assert S.host_ranges(tr, "sqp.linearize") == [(100, 200), (300, 400)]
    assert S.host_ms(tr, "sqp.linearize") == pytest.approx(2e-4)
    assert T.host_span_ms(tr, "sqp.linearize") == pytest.approx(4.1e-4)
    assert S.host_ms(tr, "mpc.solve") is None


def test_self_time_subtracts_nested_children_once():
    tr = T.build([W, _ann("mpc.solve", 100, 500, corr=1),
                  _ann("sqp.linearize", 150, 300, corr=2),
                  _ann("inner", 200, 250, corr=3),
                  _ann("sqp.riccati", 350, 400, corr=4),
                  _ann("sqp.riccati", 380, 480, corr=4),
                  _ann("mpc.solve", 140, 560, corr=1),
                  _ann("sqp.line_search", 600, 700, corr=6)], 2)
    assert S.self_ms(tr, "mpc.solve") == pytest.approx(200e-6)
    assert S.per_step(S.self_ms(tr, "mpc.solve"), tr) == pytest.approx(
        100e-6)
    assert S.self_ms(tr, "wbc.data") is None
    assert S.per_step(None, tr) is None


def test_device_time_under_a_range_is_a_union_of_its_launches():
    tr = T.build([W, _ann("sqp.riccati", 100, 300),
                  _op(11, 110, 120), _op(12, 150, 160), _op(13, 400, 410),
                  _op(14, 150, 160, thread=2),
                  _kernel(11, 500, 600), _kernel(12, 550, 650),
                  _kernel(13, 700, 800), _kernel(14, 850, 900)], 1)
    assert S.device_ms_under(tr, "sqp.riccati") == pytest.approx(150e-6)
    assert S.device_ms_under(tr, "sqp.linearize") is None
    cpu = T.build([W, _ann("sqp.riccati", 100, 300), _op(11, 110, 120)], 1)
    assert S.device_ms_under(cpu, "sqp.riccati") is None


def test_launches_count_the_window_alone():
    tr = T.build([_ann(T.WINDOW, 100, 1000), _kernel(1, 50, 90),
                  _kernel(2, 150, 200), _kernel(3, 990, 1100),
                  _kernel(4, 1000, 1200), _ann("sqp.riccati", 120, 130)], 2)
    assert S.launches(tr) == 2
    assert S.per_step(S.launches(tr), tr) == 1
    assert S.launches(T.build([W, _ann("x", 1, 2)], 1)) is None


@pytest.fixture(scope="module")
def listed_bench(small_bench, tmp_path_factory):
    """The cut benchmark with the stage readers in its cells' lists; the
    hardware cell traces five ticks, so that one of them solves."""
    root = str(tmp_path_factory.mktemp("spans") / "qmbench")
    shutil.copytree(small_bench, root)
    for cell, names in READERS.items():
        path = os.path.join(root, "workloads", f"{cell}.json")
        with open(path) as fh:
            wl = json.load(fh)
        wl["per_layer"] += names
        if "substeps" in wl["traffic"]:
            wl["trace_steps"] = round(wl["traffic"]["control_freq"]
                                      / wl["traffic"]["mpc_freq"])
        with open(path, "w") as fh:
            json.dump(wl, fh)
    return root


@pytest.mark.parametrize("cell", sorted(READERS))
def test_stage_readers_read_a_traced_cpu_run(listed_bench, cell):
    r = harness.run_cell(listed_bench, cell, SEED, 0.5, True, device="cpu")
    assert r["correct"] is True
    got = r["metrics"]
    for name in READERS[cell]:
        mod = harness.reader(listed_bench, name)
        assert mod.UNIT in ("ms", "launches")
        if name in DEVICE_ONLY:
            assert name not in got, name        # no device on the CPU
        else:
            assert got[name]["value"] > 0, name
            assert got[name]["unit"] == "ms"
