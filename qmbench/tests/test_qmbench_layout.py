"""The benchmark is driven by data, imports neither JAX nor the JAX package,
and its reference imports nothing of the port."""
import ast
import json
import os

import torch

from conftest import BENCH, REPO
from qmbench import harness, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "qm_control_tpu"}


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _imports(path):
    """Top-level names of the modules a file imports (relative imports
    resolve inside qmbench/)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and arg.values and \
                    isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


def _py_files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_benchmark_names_resolve_to_files():
    b = _bench()
    assert b["paths"] == ["qmbench"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"] == f"qmbench/configs/{c['name']}.json"
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        wl, cfg, drv = harness.find_cell(BENCH, w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert hasattr(drv, "Driver")
        assert set(wl["end_to_end"]) | {"setup_s"} <= e2e
    for m in b["per_layer"]:
        mod = harness.reader(BENCH, m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
        for w in m["workloads"]:
            with open(os.path.join(BENCH, "workloads", f"{w}.json")) as fh:
                wl = json.load(fh)
            assert m["name"] in wl["per_layer"]
            assert m["moves"] in wl["end_to_end"]


def test_per_layer_lists_only_known_readers():
    names = {m["name"] for m in _bench()["per_layer"]}
    for f in os.listdir(os.path.join(BENCH, "workloads")):
        with open(os.path.join(BENCH, "workloads", f)) as fh:
            assert set(json.load(fh)["per_layer"]) <= names


def test_no_file_imports_jax_or_the_jax_package():
    for path in _py_files(BENCH):
        found = _imports(path) & FORBIDDEN
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_port():
    for path in _py_files(os.path.join(BENCH, "reference")):
        found = _imports(path) & (FORBIDDEN | {"qm_control_tpu_torch",
                                               "qmbench"})
        assert not found, (path, found)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "qm_control_tpu_torch_x", object())
    assert "qm_control_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qm_control_tpu.config", object())
    assert harness.forbidden_modules() == ["qm_control_tpu"]


def test_config_stack_shapes_match_the_reference():
    """The WBC stack shapes that K1's frozen count reads are the shapes of
    the reference's stack."""
    from qmbench import reference
    from qmbench.reference.mpc import Ocp
    from qmbench.reference.wbc import desired, levels, measured
    robot, info = reference.model()
    x, _ = traffic.standing(harness.load_json(os.path.join(
        BENCH, "configs", "robot_hw_stance.json")))
    x = torch.as_tensor(x, dtype=torch.float64)
    u = torch.zeros(30, dtype=torch.float64)
    m = measured(robot, x[6:30], torch.zeros(24, dtype=torch.float64),
                 torch.ones(4))
    d = desired(robot, Ocp(robot, info, 3, 0.04), x, u, u, 0.002)
    d["u_des"] = u
    (A0, _, D, _), (A1, _), (A2, _) = levels(m, d, robot.effort)
    for c in os.listdir(os.path.join(BENCH, "configs")):
        cfg = harness.load_json(os.path.join(BENCH, "configs", c))
        assert cfg["wbc_stack"] == dict(
            ma0=A0.shape[0], nv=D.shape[0], ma1=A1.shape[0],
            ma2=A2.shape[0], qp_iters=10)


def test_traffic_is_deterministic_per_seed_and_differs_across_seeds():
    cfg = harness.load_json(os.path.join(BENCH, "configs",
                                         "fleet_trot.json"))
    seed = 2 ** 31 + 17
    a, x0 = traffic.fleet_state(cfg, {"batch": 64}, seed, "cpu")
    b, _ = traffic.fleet_state(cfg, {"batch": 64}, seed, "cpu")
    c, _ = traffic.fleet_state(cfg, {"batch": 64}, seed + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    dz = a[:, 8] - x0[8]
    assert float(dz.abs().max()) <= cfg["height_spread"]
    assert torch.equal(a[:, :8], x0[None, :8].expand(64, 8))
    q1 = traffic.robot_spawn(cfg, seed)
    assert (q1 == traffic.robot_spawn(cfg, seed)).all()
    assert (q1 != traffic.robot_spawn(cfg, seed + 1)).any()
    s1 = traffic.sample(seed, 4096, 8, first=(0, 4095))
    assert s1 == traffic.sample(seed, 4096, 8, first=(0, 4095))
    assert s1 != traffic.sample(seed + 1, 4096, 8, first=(0, 4095))
    assert len(set(s1)) == 8 and {0, 4095} <= set(s1)
