"""PyTorch port vs JAX reference: the WBC update (task functions + K1).

Inputs of tests/test_kernels.py:test_wbc_update_fused_flag (stance) and
its trot counterpart (flags LF+RH, v = 0.05), built independently by each
package from the same numpy state. The JAX side runs with
fused_cascade=True (on the CPU that is fused_hoqp_reference — without the
flag it would compare against the pivoted XLA cascade, another solver).

Tolerances: task matrices within rtol 1e-4 / atol 1e-3 (f32 products of
O(100) entries, plus M-dot terms); torques within 0.1 Nm on stance
(measured 0.008 Nm) and 2.0 Nm on trot (measured 1.96 Nm: the trot
optimum wanders +-0.7 Nm under last-bit input dust,
tests/test_kernels.py:185-193, and the two packages build the task
matrices with different f32 rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.config import WbcGains as JGains
from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as j_load_model
from qm_control_tpu.models.spec import default_q
from qm_control_tpu.wbc.wbc import hierarchical_wbc_update as j_update

from qm_control_tpu_torch.config import WbcGains as TGains
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as t_load_model
from qm_control_tpu_torch.wbc.wbc import HierarchicalWbc, wbc_stack
from qm_control_tpu_torch.wbc.wbc import hierarchical_wbc_update as t_update

torch.set_num_threads(1)

CASES = {"stance": (np.ones(4, np.float32), np.zeros(24, np.float32), 0.1),
         "trot": (np.array([1., 0., 0., 1.], np.float32),
                  np.full(24, 0.05, np.float32), 2.0)}


@pytest.fixture(scope="module")
def setup():
    jm, tm = j_load_model(), t_load_model()
    ji, ti = JC.make_centroidal_info(jm), TC.make_centroidal_info(tm)
    x = np.zeros(30, dtype=np.float32)
    x[6:30] = default_q(base_pos=(0, 0, 0.4))
    jgains = dataclasses.replace(JGains(), arm_settling_time=0.0)
    tgains = dataclasses.replace(TGains(), arm_settling_time=0.0)
    jfn = jax.jit(lambda xx, u, ul, q, v, fl, per, tm_: j_update(
        jm, ji, jgains, jnp.asarray(jm.joint_effort, jnp.float32), xx, u,
        ul, q, v, fl, per, tm_, fused_cascade=True))
    return jm, tm, ji, ti, x, tgains, jfn


def _args(x, flags, vq):
    return (x, np.zeros(30, np.float32), np.zeros(30, np.float32), x[6:30],
            vq, flags, np.float32(0.002), np.float32(20.0))


@pytest.mark.parametrize("case", list(CASES))
def test_wbc_update_matches_jax(setup, case):
    jm, tm, ji, ti, x, tgains, jfn = setup
    flags, vq, tol = CASES[case]
    args = _args(x, flags, vq)
    rj = jfn(*[jnp.asarray(a) for a in args])
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    rt = t_update(tm, ti, tgains, tau_max,
                  *[torch.as_tensor(np.asarray(a)) for a in args])
    assert torch.isfinite(rt.torques).all()
    err = np.abs(rt.torques.numpy() - np.asarray(rj.torques)).max()
    assert err < tol, err
    # the port stays inside the torque limits the JAX stack enforces
    assert (rt.torques.abs().numpy() <= tm.joint_effort + 1e-3).all()


@pytest.mark.parametrize("case", list(CASES))
def test_task_stack_matches_jax(setup, case):
    """The three priority levels the port builds equal the JAX ones."""
    from qm_control_tpu.wbc import tasks as JT
    jm, tm, ji, ti, x, tgains, _ = setup
    flags, vq, _ = CASES[case]
    args = _args(x, flags, vq)
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    _, tstack = wbc_stack(tm, ti, tgains, tau_max,
                          *[torch.as_tensor(np.asarray(a)) for a in args])
    g = tgains
    xx, u, ul, q, v, fl, per, _t = [jnp.asarray(a) for a in args]
    m_, d_ = JT.compute_wbc_data(jm, ji, xx, u, ul, q, v, fl, per)
    jt0 = (JT.floating_base_eom_task(m_)
           + JT.torque_limits_task(m_, jnp.asarray(jm.joint_effort,
                                                   jnp.float32))
           + JT.no_contact_motion_task(m_)
           + JT.friction_cone_task(m_, g.friction_coefficient))
    jt1 = (JT.base_height_task(m_, d_, g.base_height_kp, g.base_height_kd)
           + JT.base_angular_task(m_, d_, g.kp_base_angular,
                                  g.kd_base_angular)
           + JT.ee_linear_task(m_, d_, g.kp_ee_linear, g.kd_ee_linear)
           + JT.ee_angular_task(m_, d_, g.kp_ee_angular, g.kd_ee_angular)
           + JT.swing_leg_task(m_, d_, g.kp_swing, g.kd_swing)
           .scaled(g.swing_task_weight))
    jt2 = (JT.contact_force_task(m_, u)
           + JT.base_linear_task(m_, d_, g.kp_base_linear, g.kd_base_linear))
    for tt, jt in zip(tstack, (jt0, jt1, jt2)):
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-3)


def test_hierarchical_wbc_wrapper_cpu(setup):
    _, tm, _, ti, x, tgains, _ = setup
    wbc = HierarchicalWbc(tm, ti, tgains, device="cpu")
    res = wbc.update(x, np.zeros(30, np.float32), x[6:30],
                     np.zeros(24, np.float32), np.ones(4, np.float32),
                     0.002, 20.0)
    assert res.torques.shape == (18,) and torch.isfinite(res.x_opt).all()


def test_unported_cascades_raise(setup):
    """Every cascade is ported now (the name is kept from when the pivoted
    one raised). fused_cascade=False is the pivoted cascade
    (wbc/hoqp.py): bit for bit hoqp_solve on the stack, and JAX's
    hierarchical_wbc_update with its default pivoted cascade on every
    level by tests/test_torch_kernel_hoqp.py's residual criterion, its
    objectives within twice JAX's own move under 1e-7 dust on the stack
    (four draws) plus 0.2 max(|o|, 1) + 0.6, and the torques within twice
    JAX's own torque move plus 0.1 Nm (measured 0.66 Nm stance, 0.09 Nm
    trot, against JAX's dust moves of 0.90 / 2.2 Nm; on trot the level-0
    violation alone ranges 0.0-4.1 over JAX's own dust draws: these gains
    make a flatter optimum than tests/test_torch_qp.py's stacks). "xla"
    is cascade_exact on the
    stack. A loop built with LoopConfig(fused_wbc=False) ticks through the
    pivoted cascade: 3 ticks from the standing spawn against the same loop
    with JAX's hoqp_solve as its cascade, within twice that loop's own
    spread under 1e-7 dust on q plus tests/test_torch_loop.py's floors
    (q 1e-4, v 1e-3, torques 0.1 Nm, forces 1 N)."""
    import jax
    from qm_control_tpu.wbc.hoqp import hoqp_solve as j_hoqp
    from qm_control_tpu.wbc.tasks import Task as JTask
    from qm_control_tpu_torch.config import QmConfig as TQmConfig
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.kernels.cascade_exact import cascade_exact
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    from qm_control_tpu_torch.wbc.hoqp import hoqp_solve
    from qm_control_tpu_torch.wbc.tasks import recover_torques
    jm, tm, ji, ti, x, tgains, _ = setup
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    from test_torch_kernel_hoqp import _objectives, _residuals_ok
    jgains = dataclasses.replace(JGains(), arm_settling_time=0.0)
    jpivot = jax.jit(lambda *a: j_update(
        jm, ji, jgains, jnp.asarray(jm.joint_effort, jnp.float32), *a))
    j_cascade = jax.jit(lambda ts: j_hoqp(ts))
    rng = np.random.default_rng(0)
    for case in CASES:
        flags, vq, _ = CASES[case]
        np_args = _args(x, flags, vq)
        args = [torch.as_tensor(np.asarray(a)) for a in np_args]
        res = t_update(tm, ti, tgains, tau_max, *args, fused_cascade=False)
        m_, stack = wbc_stack(tm, ti, tgains, tau_max, *args)
        assert torch.equal(res.x_opt, hoqp_solve(list(stack)))
        rj = jpivot(*[jnp.asarray(a) for a in np_args])
        s64 = [tuple(a.numpy().astype(np.float64) for a in t) for t in stack]
        xt, xj = (np.asarray(a, np.float64) for a in (res.x_opt, rj.x_opt))
        assert _residuals_ok(s64, xt, xj)
        ot, oj = _objectives(s64, xt), _objectives(s64, xj)
        spread, o_spread = 0.0, np.zeros_like(oj)
        for _ in range(4):
            xd = np.asarray(j_cascade([JTask(*[jnp.asarray(a.numpy() * (
                1.0 + 1e-7 * rng.standard_normal(a.shape)), jnp.float32)
                for a in t]) for t in stack]))
            spread = max(spread, float((recover_torques(
                m_, torch.from_numpy(xd)) - torch.from_numpy(
                    np.asarray(rj.torques))).abs().max()))
            o_spread = np.maximum(o_spread, np.abs(
                _objectives(s64, xd.astype(np.float64)) - oj))
        assert (np.abs(ot - oj) <= 2.0 * o_spread + 0.2 * np.maximum(
            np.abs(oj), 1.0) + 0.6).all(), (case, ot, oj, o_spread)
        err = np.abs(res.torques.numpy() - np.asarray(rj.torques)).max()
        assert err <= 2.0 * spread + 0.1, (case, err, spread)
        xla = t_update(tm, ti, tgains, tau_max, *args, fused_cascade="xla")
        assert torch.equal(xla.x_opt, cascade_exact(*stack))

    def jax_pivoted(t0, t1, t2):
        return torch.from_numpy(np.asarray(j_cascade(
            [JTask(*[jnp.asarray(a.numpy()) for a in t])
             for t in (t0, t1, t2)])))
    cfg = TQmConfig().with_(wbc=tgains)
    loop = ControlLoop(tm, ti, cfg, LoopConfig(fused_wbc=False),
                       device="cpu")
    ref_loop = ControlLoop(tm, ti, cfg, LoopConfig(), device="cpu",
                           cascade=jax_pivoted)
    carry = loop.init_carry(default_q(base_pos=(0, 0, 0.38)))

    def outs(lp, c):
        c1, o = lp.run_ticks(c, 3)
        return [a.numpy() for a in (c1.plant.q, c1.plant.v, o.torques[-1],
                                    o.forces[-1])]
    before = K.launch_count
    port = outs(loop, carry)
    assert K.launch_count == before
    ref = outs(ref_loop, carry)
    band = np.zeros(4)
    for _ in range(2):
        qd = carry.plant.q * (1.0 + 1e-7 * torch.as_tensor(
            rng.standard_normal(24), dtype=torch.float32))
        dusted = outs(ref_loop, carry._replace(
            plant=carry.plant._replace(q=qd)))
        band = np.maximum(band, [np.abs(a - b).max()
                                 for a, b in zip(ref, dusted)])
    gaps = np.array([np.abs(a - b).max() for a, b in zip(ref, port)])
    assert (gaps <= 2.0 * band + np.array([1e-4, 1e-3, 0.1, 1.0])).all(), (
        gaps, band)


def test_task_helpers_match_jax(setup):
    """tasks.compute_measured, compute_desired and empty_task against the
    JAX package's on a perturbed trot state (rtol 1e-4 / atol 1e-3 as the
    stacks above; measured up to 3.1e-5 on h and base_acc)."""
    from qm_control_tpu.wbc import tasks as JT
    from qm_control_tpu_torch.wbc import tasks as TT
    jm, tm, ji, ti, x, _, _ = setup
    rng = np.random.default_rng(0)
    xs = x.copy()
    xs[:6] = 0.1 * rng.standard_normal(6)
    u, ul = (rng.standard_normal(30).astype(np.float32) for _ in range(2))
    q = (x[6:30] + 0.01 * rng.standard_normal(24)).astype(np.float32)
    v = (0.1 * rng.standard_normal(24)).astype(np.float32)
    fl = np.array([1., 0., 0., 1.], np.float32)
    pairs = [(JT.compute_desired(jm, ji, *map(jnp.asarray, (xs, u, ul)),
                                 jnp.float32(0.002)),
              TT.compute_desired(tm, ti, *map(torch.from_numpy, (xs, u, ul)),
                                 torch.tensor(0.002))),
             (JT.compute_measured(jm, *map(jnp.asarray, (q, v, fl))),
              TT.compute_measured(tm, *map(torch.from_numpy, (q, v, fl))))]
    for jr, tr in pairs:
        for a, b in zip(jr, tr):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                       atol=1e-3)
    e = TT.empty_task()
    assert [tuple(a.shape) for a in e] == [(0, 36), (0,), (0, 36), (0,)]
