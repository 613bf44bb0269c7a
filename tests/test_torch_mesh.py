"""PyTorch port vs JAX reference: the scenario mesh (parallel/mesh.py) on
a one-rank gloo group in this process (torn down after the module).

The batch is tests/test_parallel.py:_make_batch with its heights drawn
from a seeded numpy generator (+-0.01 m), at its horizon (0.12 s /
0.04 s, 1 SQP iteration), handed to both packages as numpy
(interop.batch_scenario_from_numpy). Tolerances:
  * sharded_mpc_step against the port's make_batched_mpc_step on the same
    batch, two receding-horizon steps: bit for bit (one rank runs the same
    function on the same rows);
  * against JAX's sharded_mpc_step on make_mesh(jax.devices()[:8]) at
    B = 16: per scenario tests/test_torch_parallel.py's batched
    tolerances, cost 1e-3 relative, X 2e-3, W 0.5 N, the same alpha;
  * mean_cost within rtol 1e-5 of the mean of the gathered costs
    (tests/test_parallel.py:82's bound), and within 1e-3 relative of
    JAX's mean_cost.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.utils._pytree import tree_leaves

from test_torch_parallel import _cfgs, _close

from qm_control_tpu_torch.interop import batch_scenario_from_numpy
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model
from qm_control_tpu_torch.parallel import (make_batched_mpc_step, make_mesh,
                                           shard_scenarios, sharded_mpc_step)
from qm_control_tpu_torch.parallel.mesh import DP_AXIS, local_rows

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized(), "a process group outlived its test"
    m = make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_model():
    tm = load_model()
    return tm, TC.make_centroidal_info(tm)


def seeded_batches(B, jcfg, seed=0):
    """(JAX BatchScenario, port BatchScenario on the CPU) from the same
    numpy leaves: tests/test_parallel.py's batch, heights from a seed."""
    from test_parallel import _make_batch
    jb = _make_batch(B, jcfg)
    x = np.asarray(jb.x).copy()
    x[:, 8] = 0.38 + np.random.default_rng(seed).uniform(-0.01, 0.01, B)
    jb = jb._replace(x=jnp.asarray(x))
    leaves = [np.asarray(a) for a in (jb.t, jb.x, jb.target.times,
                                      jb.target.states, jb.ms.event_times,
                                      jb.ms.modes, jb.W_warm, jb.X_warm)]
    return jb, batch_scenario_from_numpy(*leaves, device="cpu")


def test_sharded_step_is_the_batched_step_on_one_rank(mesh, port_model):
    tm, ti = port_model
    _, tcfg = _cfgs(0.12, 0.04, settle=True)
    _, tb = seeded_batches(4, _cfgs(0.12, 0.04, settle=True)[0])
    step = make_batched_mpc_step(tm, ti, tcfg)
    run = sharded_mpc_step(mesh, step)
    sb = shard_scenarios(mesh, tb)
    rb = tb
    for _ in range(2):          # the second step from the returned batch
        rb, rp = step(rb)
        sb, sp, mean_cost = run(sb)
        for a, b in zip(tree_leaves((sb, sp)), tree_leaves((rb, rp))):
            assert isinstance(a, DTensor)
            assert torch.equal(a.full_tensor(), b)
        assert mean_cost.dim() == 0 and not isinstance(mean_cost, DTensor)
        np.testing.assert_allclose(float(mean_cost), float(rp.cost.mean()),
                                   rtol=1e-5)


def test_sharded_step_matches_jax_mesh(model, mesh, port_model):
    from qm_control_tpu.models import centroidal as JC
    from qm_control_tpu.parallel.batch import make_batched_mpc_step as jmake
    from qm_control_tpu.parallel.mesh import make_mesh as jmake_mesh
    from qm_control_tpu.parallel.mesh import sharded_mpc_step as jsharded
    tm, ti = port_model
    jcfg, tcfg = _cfgs(0.12, 0.04, settle=True)
    B = 16
    jb, tb = seeded_batches(B, jcfg, seed=1)
    jrun = jsharded(jmake_mesh(jax.devices()[:8]),
                    jmake(model, JC.make_centroidal_info(model), jcfg))
    _, jp, jmean = jrun(jb)
    _, tp, tmean = sharded_mpc_step(mesh, make_batched_mpc_step(
        tm, ti, tcfg))(tb)
    full = type(tp)(*[a.full_tensor() for a in tp])
    costs = full.cost.numpy()
    assert np.isfinite(costs).all() and np.unique(costs).size > 1
    for i in range(B):
        _close(jp, full, i)
    np.testing.assert_allclose(float(tmean), costs.mean(), rtol=1e-5)
    assert abs(float(tmean) - float(jmean)) <= 1e-3 * max(
        1.0, abs(float(jmean)))


def test_shard_scenarios_places_rows_as_shard0(mesh):
    """Every tensor leaf becomes a Shard(0) DTensor over the mesh holding
    this rank's rows; None leaves (a CycleCarry without a policy) stay."""
    _, tb = seeded_batches(8, _cfgs(0.12, 0.04, settle=True)[0])
    sharded, none = shard_scenarios(mesh, (tb, None))
    assert none is None
    for a, b in zip(tree_leaves(sharded), tree_leaves(tb)):
        assert isinstance(a, DTensor)
        assert tuple(a.placements) == (Shard(0),)
        assert a.device_mesh == mesh and a.shape == b.shape
        assert torch.equal(a.to_local(), b) and a.dtype == b.dtype
    again = local_rows(mesh, shard_scenarios(mesh, sharded))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                  tree_leaves(tb)))
    assert mesh.mesh_dim_names == (DP_AXIS,) and mesh.size() == 1


def test_leaf_without_batch_axis_raises(mesh):
    """A 0-d leaf has no batch axis to shard (JAX's P("dp") refuses it
    too); indivisible batches are refused in the two-rank test of
    tests/test_torch_distributed.py."""
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        shard_scenarios(mesh, {"t": torch.tensor(0.0)})


def test_make_mesh_refuses_more_devices_than_ranks(mesh):
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh([0, 1], device="cpu")
    with pytest.raises(ValueError, match="ranks of a world of 1"):
        make_mesh([1], device="cpu")
