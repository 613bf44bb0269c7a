"""The port stands alone: no .py under qm_control_tpu_torch/ nor the chip
script chip_smoke.py imports jax or the JAX package, or opens a path into
it (a string argument naming the qm_control_tpu directory in a call that
opens, joins or loads a path).

Checked statically (AST), because a test process may already hold jax in
sys.modules (the JAX tests, or an interpreter start-up hook import it).
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "qm_control_tpu_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


_PATH_CALLS = ("open", "join", "Path", "load_model", "exists", "isfile",
               "isdir", "listdir", "CDLL", "load", "loadtxt", "abspath",
               "realpath", "run", "Popen", "check_output")


def _into_jax_package(v: str) -> bool:
    parts = v.replace("\\", "/").split("/")
    return "qm_control_tpu" in parts


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "qm_control_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            strs = [a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            if name in ("import_module", "__import__"):
                bad += [v for v in strs if _forbidden(v)]
            elif name in _PATH_CALLS:
                # a file path into the JAX package
                bad += [v for v in strs if _into_jax_package(v)]
    assert not bad, f"{os.path.relpath(path, ROOT)} reaches the JAX side: {bad}"


def test_port_carries_its_own_model_json():
    assert os.path.exists(os.path.join(PORT, "models",
                                       "aliengo_j2n6s300.json"))
