"""PyTorch port vs JAX reference: scenario batching (parallel/batch.py):
the batched MPC step, the batched WBC, and K1's custom op under vmap.
The batched closed-loop cycle is in tests/test_torch_parallel_cycle.py,
experiments.batched_rollouts in tests/test_torch_experiments.py.

Both packages start from the same numpy state (interop's converters).
Tolerances:
  * batched MPC step (tests/test_torch_mpc.py's horizon, 0.24 s / 0.04 s,
    B = 4 with heights spread over +-0.01 m as tests/test_parallel.py
    builds them), two receding-horizon steps: per scenario as
    tests/test_torch_mpc.py holds one solve against JAX: cost 1e-3
    relative, X 2e-3, W 0.5 N, the same alpha. Against the port's
    unbatched mpc_step per scenario (the same arithmetic, summed in
    another order by the batched products): X 1e-5 (measured 2.4e-7),
    W 1e-3 N (1.4e-4 N), cost 2e-4 relative (8.3e-5, on the first step
    from the cold-initialized warm start; 4.2e-7 after it), the same
    alpha.
  * batched WBC with the "xla" cascade (B = 3: stance, trot, trot at
    another joint velocity) against JAX's make_batched_wbc: stance
    torques within tests/test_torch_cascade_exact.py's batched 0.2 Nm
    (measured 0.167 Nm). The trot optimum is flat: the JAX package's own
    "xla" and fused cascades land 3.6-4.7 Nm apart on these inputs, and
    its batched call 0.7-4.6 Nm from its single call (the level-0
    violation 2.2 batched, 5.3 single), so every scenario is held on the
    per-level objectives of the port's stack: within twice the JAX
    batch's own gap to JAX's single call plus 0.2 max(|o|, 1) + 0.6, and
    the residual criterion of tests/test_torch_kernel_hoqp.py.
  * the custom op under vmap on CPU tensors: bit for bit a loop of
    fused_hoqp (its CPU implementation solves one cascade at a time).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_control_tpu.config import MpcConfig, QmConfig
from test_torch_cascade_exact import _batched, _port_stack
from test_torch_kernel_hoqp import _objectives, _residuals_ok

from qm_control_tpu_torch import config as TCfg
from qm_control_tpu_torch.interop import batch_scenario_from_numpy
from qm_control_tpu_torch.kernels import hoqp_fused as K
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model
from qm_control_tpu_torch.mpc.mpc import mpc_step
from qm_control_tpu_torch.ocp.problem import make_ocp
from qm_control_tpu_torch.parallel import (make_batched_mpc_step,
                                           make_batched_wbc)
from qm_control_tpu_torch.solver.sqp import SqpSettings
from qm_control_tpu_torch.wbc.tasks import Task as TTask
from qm_control_tpu_torch.wbc.wbc import wbc_stack

torch.set_num_threads(1)


def _cfgs(horizon, dt, settle=False):
    """(JAX cfg, port cfg) at one horizon, 1 SQP iteration; settle=False
    sets arm_settling_time 0 as the closed-loop experiments do."""
    jcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=horizon, dt=dt,
                                          num_iterations=1))
    tcfg = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=horizon, dt=dt, num_iterations=1))
    if not settle:
        jcfg = jcfg.with_(wbc=dataclasses.replace(jcfg.wbc,
                                                  arm_settling_time=0.0))
        tcfg = tcfg.with_(wbc=dataclasses.replace(tcfg.wbc,
                                                  arm_settling_time=0.0))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def port_model():
    tm = load_model()
    return tm, TC.make_centroidal_info(tm)


def _close(jp, tp, i):
    assert float(tp.alpha[i]) == float(jp.alpha[i])
    jc = float(jp.cost[i])
    assert abs(float(tp.cost[i]) - jc) <= 1e-3 * max(1.0, abs(jc))
    np.testing.assert_allclose(tp.X[i].numpy(), np.asarray(jp.X[i]),
                               atol=2e-3)
    np.testing.assert_allclose(tp.W[i].numpy(), np.asarray(jp.W[i]),
                               atol=0.5)


def test_batched_mpc_step_matches_jax_and_unbatched(model, port_model):
    """Two receding-horizon steps of the fleet (cold-initialized warm
    starts, then the returned ones) in both packages."""
    from qm_control_tpu.models import centroidal as JC
    from qm_control_tpu.parallel.batch import make_batched_mpc_step as jmake
    from test_parallel import _make_batch
    tm, ti = port_model
    jcfg, tcfg = _cfgs(0.24, 0.04, settle=True)
    B = 4
    jb = _make_batch(B, jcfg)
    jstep = jax.jit(jmake(model, JC.make_centroidal_info(model), jcfg))
    tb = batch_scenario_from_numpy(
        *[np.asarray(a) for a in (jb.t, jb.x, jb.target.times,
                                  jb.target.states, jb.ms.event_times,
                                  jb.ms.modes, jb.W_warm, jb.X_warm)],
        device="cpu")
    tstep = make_batched_mpc_step(tm, ti, tcfg)
    ocp = make_ocp(tm, ti, tcfg)
    settings = SqpSettings(num_iterations=1)
    period, cold = torch.tensor(0.01), torch.tensor(False)
    for _ in range(2):
        jb, jp = jstep(jb)
        tin = tb
        tb, tp = tstep(tb)
        costs = tp.cost.numpy()
        assert np.isfinite(costs).all() and np.unique(costs).size > 1
        assert torch.equal(tb.W_warm, tp.W) and torch.equal(tb.X_warm, tp.X)
        for i in range(B):
            _close(jp, tp, i)
            one = mpc_step(ocp, tm, ti, tcfg, settings, tin.t[i], tin.x[i],
                           type(tin.target)(*[a[i] for a in tin.target]),
                           type(tin.ms)(*[a[i] for a in tin.ms]),
                           tin.W_warm[i], tin.X_warm[i], period, cold)
            assert float(one.alpha) == float(tp.alpha[i])
            assert abs(float(one.cost) - costs[i]) <= 2e-4 * max(
                1.0, abs(costs[i]))
            assert float((one.X - tp.X[i]).abs().max()) <= 1e-5
            assert float((one.W - tp.W[i]).abs().max()) <= 1e-3


def _wbc_inputs():
    """B = 3 WBC inputs (stance; trot v = 0.05; trot v = 0.03) at the
    standing state of tests/test_torch_wbc.py."""
    from qm_control_tpu.models.spec import default_q
    x = np.zeros(30, np.float32)
    x[6:30] = default_q(base_pos=(0, 0, 0.4))
    flags = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [1, 0, 0, 1]], np.float32)
    v = np.stack([np.zeros(24), np.full(24, 0.05), np.full(24, 0.03)])
    z = np.zeros((3, 30), np.float32)
    return (np.tile(x, (3, 1)), z, z, np.tile(x[6:30], (3, 1)),
            v.astype(np.float32), flags)


def test_batched_wbc_xla_matches_jax(model, port_model):
    from qm_control_tpu.models import centroidal as JC
    from qm_control_tpu.parallel.batch import make_batched_wbc as jmake
    tm, ti = port_model
    jcfg, tcfg = _cfgs(0.24, 0.04)
    args = _wbc_inputs()
    jw = jax.jit(jmake(model, JC.make_centroidal_info(model), jcfg.wbc,
                       cascade="xla"))
    jr = jw(*map(jnp.asarray, args), jnp.float32(0.002), jnp.float32(20.0))
    tw = make_batched_wbc(tm, ti, tcfg.wbc, cascade="xla", device="cpu")
    tr = tw(*map(torch.from_numpy, args), torch.tensor(0.002),
            torch.tensor(20.0))
    assert tr.torques.shape == (3, 18) and torch.isfinite(tr.x_opt).all()
    err = np.abs(tr.torques[0].numpy() - np.asarray(jr.torques[0])).max()
    assert err < 0.2, err
    from qm_control_tpu.wbc.wbc import hierarchical_wbc_update as jupdate
    jinfo = JC.make_centroidal_info(model)
    jeffort = jnp.asarray(model.joint_effort, jnp.float32)
    jone = jax.jit(lambda *a: jupdate(model, jinfo, jcfg.wbc, jeffort, *a,
                                      fused_cascade="xla").x_opt)
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    for i in range(3):
        _, stack = wbc_stack(tm, ti, tcfg.wbc, tau_max,
                             *[torch.from_numpy(a[i]) for a in args],
                             torch.tensor(0.002), torch.tensor(20.0))
        stack = [tuple(a.numpy().astype(np.float64) for a in t)
                 for t in stack]
        xt = tr.x_opt[i].numpy().astype(np.float64)
        xj = np.asarray(jr.x_opt[i], np.float64)
        x1 = np.asarray(jone(*[jnp.asarray(a[i]) for a in args],
                             jnp.float32(0.002), jnp.float32(20.0)),
                        np.float64)
        assert _residuals_ok(stack, xt, xj)
        ot, oj, o1 = (_objectives(stack, x) for x in (xt, xj, x1))
        assert (np.abs(ot - oj) <= 2.0 * np.abs(o1 - oj) + 0.2 * np.maximum(
            np.abs(oj), 1.0) + 0.6).all(), (i, ot, oj, o1)
    with pytest.raises(NotImplementedError):
        make_batched_wbc(tm, ti, cascade="hoqp", device="cpu")


def test_custom_op_under_vmap_is_a_loop_of_fused_hoqp(port_model):
    """vmap over fused_hoqp reaches the op's vmap rule: on CPU tensors the
    batch is the plain cascade per scenario, bit for bit, cold and warm
    (batched or shared warm buffer), also under nested vmaps; no K1
    launch is counted."""
    tm, ti = port_model
    stack_list = [_port_stack(tm, ti, (1., 1., 1., 1.), 0.0),
                  _port_stack(tm, ti, (1., 0., 0., 1.), 0.05),
                  _port_stack(tm, ti, (1., 0., 0., 1.), 0.03)]
    bt = _batched(stack_list)
    singles = [[TTask(*[a[i] for a in t]) for t in bt] for i in range(3)]
    before = (K.launch_count, K.block_count)
    xv, wv = vmap(lambda a, b, c: K.fused_hoqp(a, b, c, return_warm=True))(
        *bt)
    ref = [K.fused_hoqp(*s, return_warm=True) for s in singles]
    assert torch.equal(xv, torch.stack([r[0] for r in ref]))
    assert torch.equal(wv, torch.stack([r[1] for r in ref]))
    xw = vmap(lambda a, b, c, w: K.fused_hoqp(a, b, c, warm=w))(*bt, wv)
    assert torch.equal(xw, torch.stack([K.fused_hoqp(*s, warm=r[1])
                                        for s, r in zip(singles, ref)]))
    shared = ref[1][1]
    xs = vmap(lambda a, b, c: K.fused_hoqp(a, b, c, warm=shared))(*bt)
    assert torch.equal(xs, torch.stack([K.fused_hoqp(*s, warm=shared)
                                        for s in singles]))
    nested = [TTask(*[a.reshape(3, 1, *a.shape[1:]) for a in t]) for t in bt]
    xn = vmap(vmap(K.fused_hoqp))(*nested)
    assert torch.equal(xn[:, 0], xv)
    assert (K.launch_count, K.block_count) == before


def test_custom_op_registered_without_gpu():
    """Importing the port registers K1's op without a GPU and without
    building the kernel."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert hasattr(torch.ops.qm_control_tpu_torch, "hoqp_fused")
    assert K._lib is None
