"""Hierarchical whole-body controllers (port of qm_control_tpu/wbc/wbc.py;
reference qm_wbc/src/HierarchicalWbc.cpp:18-44 and
HierarchicalMpcWbc.cpp:18-34):

  T0 (hard):   floating-base EoM + torque limits + stance no-motion +
               friction cone
  T1 (track):  base height + base angular + EE linear + EE angular +
               100 x swing leg   [before arm_settling_time: arm-joint
               nominal tracking instead, as a row-level blend]
  T2 (slack):  contact-force tracking + base linear

The MPC-only variant (`hierarchical_mpc_wbc_update`, the arm under
position control) has no arm or EE task: T1 is base height + base
angular + base linear + swing leg, T2 contact-force tracking.

The cascade: K1 (kernels.hoqp_fused.fused_hoqp; the CUDA kernel on the
card, its plain version on CPU tensors, one launch for a whole
`torch.func.vmap` batch), "xla" (kernels/cascade_exact.py, the JAX
package's batch path) or False, the pivoted cascade (wbc/hoqp.py +
wbc/qp.py). hierarchical_wbc_update defaults to K1 where the JAX function
defaults to the pivoted cascade; hierarchical_mpc_wbc_update keeps JAX's
default, the pivoted cascade.
"""
from typing import NamedTuple

import torch

from ..config import WbcGains
from ..models import centroidal as C
from ..models.spec import RobotModel
from .hoqp import hoqp_solve
from .tasks import (Task, arm_joint_tracking_task, base_angular_task,
                    base_height_task, base_linear_task, compute_wbc_data,
                    contact_force_task, ee_angular_task, ee_linear_task,
                    floating_base_eom_task, friction_cone_task,
                    no_contact_motion_task, recover_torques, swing_leg_task,
                    torque_limits_task)


class WbcResult(NamedTuple):
    x_opt: torch.Tensor      # (36,) [v_dot(24); F(12)]
    torques: torch.Tensor    # (18,) actuated joint torques
    vdot: torch.Tensor       # (24,)
    forces: torch.Tensor     # (12,)


def _blend_tasks(t_a, t_b, w_b):
    """Row-shape-identical blend (1-w) A + w B on (A, b); D, f empty."""
    return Task((1.0 - w_b) * t_a.A + w_b * t_b.A,
                (1.0 - w_b) * t_a.b + w_b * t_b.b, t_a.D, t_a.f)


def _hard_level(m, gains: WbcGains, tau_max, ee_wrench):
    """T0, the hard level of both stacks."""
    return (floating_base_eom_task(m, ee_wrench)
            + torque_limits_task(m, tau_max, ee_wrench)
            + no_contact_motion_task(m)
            + friction_cone_task(m, gains.friction_coefficient))


def _pivoted(t0, t1, t2):
    return hoqp_solve([t0, t1, t2])


def _result(m, x_opt, ee_wrench) -> WbcResult:
    return WbcResult(x_opt=x_opt, torques=recover_torques(m, x_opt, ee_wrench),
                     vdot=x_opt[:24], forces=x_opt[24:])


def wbc_stack(model: RobotModel, info: C.CentroidalInfo, gains: WbcGains,
              tau_max, state_des, input_des, input_last, q, v,
              contact_flags, period, time, ee_wrench=None):
    """(WbcData, (t0, t1, t2)): the three priority levels of one tick."""
    m, d = compute_wbc_data(model, info, state_des, input_des, input_last,
                            q, v, contact_flags, period)
    t0 = _hard_level(m, gains, tau_max, ee_wrench)
    t1_run = (base_height_task(m, d, gains.base_height_kp,
                               gains.base_height_kd)
              + base_angular_task(m, d, gains.kp_base_angular,
                                  gains.kd_base_angular)
              + ee_linear_task(m, d, gains.kp_ee_linear, gains.kd_ee_linear)
              + ee_angular_task(m, d, gains.kp_ee_angular,
                                gains.kd_ee_angular)
              + swing_leg_task(m, d, gains.kp_swing,
                               gains.kd_swing).scaled(gains.swing_task_weight))
    # arm settling: T1 is arm-joint nominal tracking only, padded with
    # zero rows to the run stack's shape and blended by a time gate
    t1_init = arm_joint_tracking_task(m, d, gains.kp_arm_joints,
                                      gains.kd_arm_joints)
    pad = t1_run.A.shape[0] - t1_init.A.shape[0]
    t1_init_padded = Task(
        torch.cat([t1_init.A, t1_init.A.new_zeros((pad, t1_init.A.shape[1]))]),
        torch.cat([t1_init.b, t1_init.b.new_zeros(pad)]),
        t1_run.D, t1_run.f)
    w_run = (torch.as_tensor(time, device=q.device)
             >= gains.arm_settling_time).to(q.dtype)
    t1 = _blend_tasks(t1_init_padded, t1_run, w_run)
    t2 = contact_force_task(m, input_des) + base_linear_task(
        m, d, gains.kp_base_linear, gains.kd_base_linear)
    return m, (t0, t1, t2)


def hierarchical_wbc_update(model: RobotModel, info: C.CentroidalInfo,
                            gains: WbcGains, tau_max,
                            state_des, input_des, input_last,
                            q, v, contact_flags, period, time,
                            ee_wrench=None,
                            fused_cascade=True,
                            cascade=None) -> WbcResult:
    """One WBC solve (reference HierarchicalWbc::update :18-44). ee_wrench:
    measured world wrench [f(3); tau(3)] at the arm EE, entering the EoM,
    torque limits and torque recovery. fused_cascade: True (K1,
    kernels.hoqp_fused.fused_hoqp), "xla" (kernels.cascade_exact) or
    False (the pivoted cascade, wbc.hoqp.hoqp_solve). cascade: an
    explicit solver of the three levels, overriding fused_cascade;
    chip_smoke.py passes cascade_plain to hold the main path on the card
    against the plain version."""
    if cascade is None and fused_cascade == "xla":
        from ..kernels.cascade_exact import cascade_exact as cascade
    elif cascade is None and fused_cascade:
        from ..kernels.hoqp_fused import fused_hoqp as cascade
    elif cascade is None:
        cascade = _pivoted
    m, (t0, t1, t2) = wbc_stack(model, info, gains, tau_max, state_des,
                                input_des, input_last, q, v, contact_flags,
                                period, time, ee_wrench)
    return _result(m, cascade(t0, t1, t2), ee_wrench)


def mpc_wbc_stack(model: RobotModel, info: C.CentroidalInfo, gains: WbcGains,
                  tau_max, state_des, input_des, input_last, q, v,
                  contact_flags, period, ee_wrench=None):
    """(WbcData, (t0, t1, t2)): the MPC-only variant's levels (reference
    HierarchicalMpcWbc.cpp:18-34), 30/56, 18 and 12 rows."""
    m, d = compute_wbc_data(model, info, state_des, input_des, input_last,
                            q, v, contact_flags, period)
    t1 = (base_height_task(m, d, gains.base_height_kp, gains.base_height_kd)
          + base_angular_task(m, d, gains.kp_base_angular,
                              gains.kd_base_angular)
          + base_linear_task(m, d, gains.kp_base_linear, gains.kd_base_linear)
          + swing_leg_task(m, d, gains.kp_swing,
                           gains.kd_swing).scaled(gains.swing_task_weight))
    return m, (_hard_level(m, gains, tau_max, ee_wrench), t1,
               contact_force_task(m, input_des))


def hierarchical_mpc_wbc_update(model: RobotModel, info: C.CentroidalInfo,
                                gains: WbcGains, tau_max,
                                state_des, input_des, input_last,
                                q, v, contact_flags, period,
                                ee_wrench=None,
                                fused_cascade: bool = False) -> WbcResult:
    """MPC-only variant: no arm/EE tasks (the arm is handled by position
    controllers). fused_cascade: False (the pivoted cascade, the JAX
    default) or True (K1)."""
    m, stack = mpc_wbc_stack(model, info, gains, tau_max, state_des,
                             input_des, input_last, q, v, contact_flags,
                             period, ee_wrench)
    if fused_cascade:
        from ..kernels.hoqp_fused import fused_hoqp as cascade
    else:
        cascade = _pivoted
    return _result(m, cascade(*stack), ee_wrench)


class HierarchicalWbc:
    """Host-side wrapper holding one-step state (inputLast_ for the
    finite-difference joint acceleration; reference WbcBase.cpp:212-213)."""

    def __init__(self, model: RobotModel, info: C.CentroidalInfo,
                 gains: WbcGains = None, device="cuda"):
        from .. import resolve_device
        self.device = resolve_device(device)
        self.model = model
        self.info = info
        self.gains = gains or WbcGains()
        self.tau_max = torch.as_tensor(model.joint_effort,
                                       dtype=torch.float32,
                                       device=self.device)
        self._input_last = torch.zeros(30, dtype=torch.float32,
                                       device=self.device)

    def update(self, state_des, input_des, q, v, contact_flags, period,
               time) -> WbcResult:
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)
        res = hierarchical_wbc_update(
            self.model, self.info, self.gains, self.tau_max, dev(state_des),
            dev(input_des), self._input_last, dev(q), dev(v),
            dev(contact_flags), dev(period), dev(time))
        self._input_last = dev(input_des)
        return res
