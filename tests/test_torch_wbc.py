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
    """fused_cascade=False (the pivoted cascade, wbc/hoqp.py + wbc/qp.py)
    is not ported and raises, from the update and from a loop built with
    LoopConfig(fused_wbc=False); "xla" is ported (kernels/cascade_exact.py)
    and solves the same stack as cascade_exact."""
    from qm_control_tpu_torch.config import QmConfig as TQmConfig
    from qm_control_tpu_torch.kernels.cascade_exact import cascade_exact
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    _, tm, _, ti, x, tgains, _ = setup
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    args = [torch.as_tensor(np.asarray(a))
            for a in _args(x, np.ones(4, np.float32),
                           np.zeros(24, np.float32))]
    with pytest.raises(NotImplementedError):
        t_update(tm, ti, tgains, tau_max, *args, fused_cascade=False)
    res = t_update(tm, ti, tgains, tau_max, *args, fused_cascade="xla")
    _, stack = wbc_stack(tm, ti, tgains, tau_max, *args)
    assert torch.equal(res.x_opt, cascade_exact(*stack))
    loop = ControlLoop(tm, ti, TQmConfig(), LoopConfig(fused_wbc=False),
                       device="cpu")
    with pytest.raises(NotImplementedError):
        loop.run_ticks(loop.init_carry(np.asarray(x[6:30])), 1)
