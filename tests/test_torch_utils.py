"""The port's utilities against the JAX package's: checkpoint / resume
(utils/checkpoint.py), profiling (utils/profiling.py) and the support
polygon / centre of pressure of utils/viz.py.

Checkpoints round-trip a CycleCarry, an MpcPolicy and a BatchScenario bit
for bit (torch.equal, dtypes kept) onto the asked device; retention keeps
the newest two; structure drift and a file written by the JAX package
raise ValueError. Profiling: chained_latency is positive and under 50 ms
for a trivial step (the JAX test's bound), and device_trace writes a
Chrome trace. viz: equal to JAX's numpy functions on
tests/test_commands_utils.py's cases (exact: the same numpy code).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.utils import checkpoint as JCK
from qm_control_tpu.utils import viz as JV

from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.mpc.mpc import MpcPolicy
from qm_control_tpu_torch.parallel.batch import BatchScenario
from qm_control_tpu_torch.runtime.loop import ControlLoop
from qm_control_tpu_torch.utils import viz as TV
from qm_control_tpu_torch.utils.checkpoint import (RunCheckpointer,
                                                   load_pytree, save_pytree)
from qm_control_tpu_torch.utils.profiling import (RepeatedTimer,
                                                  chained_latency,
                                                  device_trace)

torch.set_num_threads(1)


def _policy(gen, lead=()):
    N = 3

    def r(*shape):
        return torch.randn((*lead, *shape), generator=gen)
    return MpcPolicy(t_nodes=r(N + 1), X=r(N + 1, 30), U=r(N + 1, 30),
                     modes=torch.randint(0, 16, (*lead, N + 1), generator=gen,
                                         dtype=torch.int32),
                     cost=r(), W=r(N, 30), alpha=r(), defect=r())


def _trees():
    gen = torch.Generator().manual_seed(0)
    cfg = _default_cfg(horizon=0.12, dt=0.04)
    model, info, q0, s = _standing_setup(cfg)
    carry = ControlLoop(model, info, cfg, device="cpu").init_carry(q0)
    from qm_control_tpu_torch.gaits.gait import ModeSchedule
    from qm_control_tpu_torch.ocp.reference import TargetTrajectory
    B = 3
    batch = BatchScenario(
        t=torch.rand(B, generator=gen), x=torch.randn(B, 30, generator=gen),
        target=TargetTrajectory(torch.rand(B, 4, generator=gen),
                                torch.randn(B, 4, 37, generator=gen)),
        ms=ModeSchedule(torch.rand(B, 5, generator=gen),
                        torch.randint(0, 16, (B, 6), generator=gen,
                                      dtype=torch.int32)),
        W_warm=torch.randn(B, 3, 30, generator=gen),
        X_warm=torch.randn(B, 4, 30, generator=gen))
    return dict(carry=carry, carry_no_policy=carry._replace(policy=None),
                policy=_policy(gen), batch=batch)


def _assert_bit_equal(a, b):
    from torch.utils._pytree import tree_flatten
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert str(sa) == str(sb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert y.device.type == "cpu" and x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", ["carry", "carry_no_policy", "policy",
                                  "batch"])
def test_pytree_roundtrip(tmp_path, name):
    tree = _trees()[name]
    p = str(tmp_path / "snap.npz")
    save_pytree(p, tree)
    like = type(tree)(*tree)      # the structure; values ignored
    restored = load_pytree(p, like, device="cpu")
    assert type(restored) is type(tree)
    _assert_bit_equal(tree, restored)


def test_run_checkpointer_retention(tmp_path):
    ck = RunCheckpointer(str(tmp_path / "ckpts"), keep=2)
    tree = {"a": torch.ones(3), "b": (torch.zeros(2), 5.0), "c": None}
    for step in (10, 20, 30, 40):
        ck.save(step, tree)
    assert [s for s, _ in ck._list()] == [30, 40]
    step, restored = ck.restore_latest(tree, device="cpu")
    assert step == 40
    assert torch.equal(restored["a"], torch.ones(3))
    assert restored["b"][1] == 5.0 and isinstance(restored["b"][1], float)
    assert restored["c"] is None
    assert RunCheckpointer(str(tmp_path / "empty")).restore_latest(
        tree, device="cpu") == (None, None)


def test_load_rejects_structure_drift(tmp_path):
    path = str(tmp_path / "snap.npz")
    save_pytree(path, {"a": torch.zeros(3), "b": torch.ones(2)})
    # same leaf count, different structure -> treedef mismatch
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_pytree(path, {"a": torch.zeros(3), "c": torch.ones(2)},
                    device="cpu")
    # insertion order is structure in torch's pytree
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_pytree(path, {"b": torch.ones(2), "a": torch.zeros(3)},
                    device="cpu")
    # different leaf count
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(path, {"a": torch.zeros(3)}, device="cpu")


def test_jax_checkpoint_is_rejected(tmp_path):
    """A file the JAX package wrote, with the same leaves, raises: it is
    never misread."""
    path = str(tmp_path / "jax.npz")
    JCK.save_pytree(path, {"a": jnp.zeros(3), "b": jnp.ones(2)})
    with pytest.raises(ValueError, match="JAX"):
        load_pytree(path, {"a": torch.zeros(3), "b": torch.ones(2)},
                    device="cpu")


def test_load_device_rule(tmp_path):
    path = str(tmp_path / "snap.npz")
    save_pytree(path, {"a": torch.zeros(3)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_pytree(path, {"a": torch.zeros(3)})


def test_profiling_chained_latency():
    """A trivial step's per-call latency is positive and under the JAX
    test's 50 ms."""
    def step(c):
        return c * 1.0000001 + 1e-9

    dt = chained_latency(step, k1=5, k2=55, reps=3)
    assert 0.0 < dt < 0.05
    step.init = lambda: torch.ones(8)
    assert 0.0 <= chained_latency(step, k1=2, k2=12, reps=2) < 0.05
    assert RepeatedTimer.__module__.endswith("timers")


def test_profiling_device_trace(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        (torch.ones(64) * 2.0).sum()
    assert prof.trace_path == os.path.join(str(tmp_path), "trace.json")
    with open(prof.trace_path) as fh:
        assert json.load(fh)["traceEvents"]


FEET = np.array([[0.3, 0.2, 0], [0.3, -0.2, 0],
                 [-0.3, 0.2, 0], [-0.3, -0.2, 0]])
UNEVEN = np.tile([0, 0, 50.0], (4, 1))
UNEVEN[0, 2] = 150.0


@pytest.mark.parametrize("flags", [[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 1],
                                   [0, 0, 0, 0]])
def test_support_polygon_matches_jax(flags):
    got = TV.support_polygon(FEET, flags)
    np.testing.assert_array_equal(got, JV.support_polygon(FEET, flags))
    assert got.shape == (sum(flags), 2)


@pytest.mark.parametrize("forces", [np.tile([0, 0, 100.0], (4, 1)), UNEVEN,
                                    np.zeros((4, 3))],
                         ids=["even", "uneven", "airborne"])
def test_center_of_pressure_matches_jax(forces):
    got = TV.center_of_pressure(FEET, forces)
    np.testing.assert_array_equal(got, JV.center_of_pressure(FEET, forces))
    if forces is UNEVEN:
        assert got[0] > 0 and got[1] > 0
