"""Fixtures of the benchmark's CPU tests: a copy of qmbench/ cut to a
size the CPU runs in seconds (horizon 0.12 s of 0.04 s nodes, a fleet of
4, a few ticks), and the card marker."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def _edit(path, fn):
    with open(path) as fh:
        d = json.load(fh)
    fn(d)
    with open(path, "w") as fh:
        json.dump(d, fh)


def shrink(root):
    """Cut the configurations and cells under `root` to CPU size."""
    for name in os.listdir(os.path.join(root, "configs")):
        _edit(os.path.join(root, "configs", name), lambda d: d["mpc"].update(
            time_horizon=0.12, dt=0.04))

    def cell(d):
        tr, chk = d["traffic"], d["check"]
        if "batch" in tr:
            tr["batch"] = 4
            chk["sample"] = 3
        d["warmup_steps"] = min(d["warmup_steps"], 6)
        d["trace_steps"] = min(d["trace_steps"], 2)
        for k, v in (("start_ticks", 2), ("solve_ticks", 1),
                     ("wbc_ticks", 1), ("control_ticks", 2)):
            if k in chk:
                chk[k] = v
    for name in os.listdir(os.path.join(root, "workloads")):
        _edit(os.path.join(root, "workloads", name), cell)


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory):
    """A copy of the benchmark's data, drivers and readers at CPU size."""
    root = tmp_path_factory.mktemp("bench") / "qmbench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "reference", "__pycache__", ".cache"))
    shrink(str(root))
    return str(root)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
