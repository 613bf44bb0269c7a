"""Hierarchical whole-body controller (port of qm_control_tpu/wbc/wbc.py;
reference qm_wbc/src/HierarchicalWbc.cpp:18-44):

  T0 (hard):   floating-base EoM + torque limits + stance no-motion +
               friction cone
  T1 (track):  base height + base angular + EE linear + EE angular +
               100 x swing leg   [before arm_settling_time: arm-joint
               nominal tracking instead, as a row-level blend]
  T2 (slack):  contact-force tracking + base linear

The cascade runs through K1 (kernels.hoqp_fused.fused_hoqp): the CUDA
kernel on the card, its plain version on CPU tensors; under
`torch.func.vmap` the whole batch is one K1 launch. `fused_cascade="xla"`
runs the exact-shape cascade in plain PyTorch (kernels/cascade_exact.py),
the JAX package's batch path. The pivoted cascade (`fused_cascade=False`:
wbc/hoqp.py + wbc/qp.py) and `hierarchical_mpc_wbc_update` are still to
port (ROADMAP); asking for them raises.
"""
from typing import NamedTuple

import torch

from ..config import WbcGains
from ..models import centroidal as C
from ..models.spec import RobotModel
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


def wbc_stack(model: RobotModel, info: C.CentroidalInfo, gains: WbcGains,
              tau_max, state_des, input_des, input_last, q, v,
              contact_flags, period, time, ee_wrench=None):
    """(WbcData, (t0, t1, t2)): the three priority levels of one tick."""
    m, d = compute_wbc_data(model, info, state_des, input_des, input_last,
                            q, v, contact_flags, period)
    t0 = (floating_base_eom_task(m, ee_wrench)
          + torque_limits_task(m, tau_max, ee_wrench)
          + no_contact_motion_task(m)
          + friction_cone_task(m, gains.friction_coefficient))
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
    kernels.hoqp_fused.fused_hoqp) or "xla" (kernels.cascade_exact);
    False (the pivoted cascade) is not ported and raises. cascade: an
    explicit solver of the three levels, overriding fused_cascade;
    chip_smoke.py passes cascade_plain to hold the main path on the card
    against the plain version."""
    if fused_cascade is not True and fused_cascade != "xla":
        raise NotImplementedError(
            f"fused_cascade={fused_cascade!r}: the pivoted XLA cascade "
            "(wbc/hoqp.py, wbc/qp.py) is a ROADMAP item still to port; use "
            "True (K1) or 'xla' (kernels/cascade_exact.py)")
    if cascade is None and fused_cascade == "xla":
        from ..kernels.cascade_exact import cascade_exact as cascade
    elif cascade is None:
        from ..kernels.hoqp_fused import fused_hoqp as cascade
    m, (t0, t1, t2) = wbc_stack(model, info, gains, tau_max, state_des,
                                input_des, input_last, q, v, contact_flags,
                                period, time, ee_wrench)
    x_opt = cascade(t0, t1, t2)
    tau = recover_torques(m, x_opt, ee_wrench)
    return WbcResult(x_opt=x_opt, torques=tau, vdot=x_opt[:24],
                     forces=x_opt[24:])


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
