"""WBC task formulations with static shapes (port of
qm_control_tpu/wbc/tasks.py; reference qm_wbc/src/WbcBase.cpp:25-595).

Contact-dependent tasks keep fixed row counts: inactive rows are
multiplied to 0 (equalities read 0 = 0; inequalities get their bound
pushed to MASK_BIG). The JAX module's `.at[].set` writes become constant
selector matrices and torch.where, so every task function is functional.

Decision vector x in R^36 = [v_dot(24); F(12)].
"""
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..models import centroidal as C
from ..models import dynamics as D
from ..models import kinematics as K
from ..models._const import const
from ..models._fwd import jacfwd, jvp
from ..models.rotations import (euler_zyx_rate_to_omega_world_matrix,
                                euler_zyx_to_R, rotation_error_world)
from ..models.spec import NQ, RobotModel

NUM_DECISION_VARS = 36
MASK_BIG = 1e6


class Task(NamedTuple):
    """Stacked task matrices: A x = b (equality), D x <= f (inequality)
    (reference qm_wbc/include/qm_wbc/Task.h:17-66). Empty blocks are
    (0, 36) tensors."""
    A: torch.Tensor
    b: torch.Tensor
    D: torch.Tensor
    f: torch.Tensor

    def __add__(self, other: "Task") -> "Task":
        return Task(torch.cat([self.A, other.A], dim=0),
                    torch.cat([self.b, other.b], dim=0),
                    torch.cat([self.D, other.D], dim=0),
                    torch.cat([self.f, other.f], dim=0))

    def scaled(self, w) -> "Task":
        return Task(self.A * w, self.b * w, self.D, self.f)


def _empty_rows(like):
    return (like.new_zeros((0, NUM_DECISION_VARS)), like.new_zeros((0,)))


def empty_task(dtype=torch.float32, device=None) -> Task:
    z, v = _empty_rows(torch.zeros((), dtype=dtype, device=device))
    return Task(z, v, z, v)


def eq_task(A, b) -> Task:
    z, zv = _empty_rows(A)
    return Task(A, b, z, zv)


def ineq_task(D_, f) -> Task:
    z, zv = _empty_rows(D_)
    return Task(z, zv, D_, f)


class WbcData(NamedTuple):
    """Measured-side precomputation (reference WbcBase::updateMeasured)."""
    q: torch.Tensor          # (24,)
    v: torch.Tensor          # (24,)
    M: torch.Tensor          # (24,24) mass matrix
    h: torch.Tensor          # (24,)  nonlinear effects
    Jc: torch.Tensor         # (12,24) stacked contact Jacobian
    dJc_v: torch.Tensor      # (12,)  dJc/dt * v
    base_J: torch.Tensor     # (6,24)
    base_dJ_v: torch.Tensor  # (6,)
    ee_J: torch.Tensor       # (6,24) arm EE Jacobian
    ee_dJ_v: torch.Tensor    # (6,)
    ee_dJ_v_noeuler: torch.Tensor  # (3,) angular rows, euler cols zeroed
    feet_pos: torch.Tensor   # (4,3)
    feet_vel: torch.Tensor   # (4,3)
    ee_pos: torch.Tensor     # (3,)
    ee_R: torch.Tensor       # (3,3)
    ee_vel: torch.Tensor     # (6,)
    contact_flags: torch.Tensor  # (4,) float 0/1


class WbcDesired(NamedTuple):
    """Desired-side precomputation (reference WbcBase::updateDesired)."""
    q: torch.Tensor             # (24,)
    v: torch.Tensor             # (24,)
    base_acc: torch.Tensor      # (6,) desired base acceleration
    feet_pos: torch.Tensor      # (4,3)
    feet_vel: torch.Tensor      # (4,3)
    ee_pos: torch.Tensor        # (3,)
    ee_R: torch.Tensor          # (3,3)
    ee_vel: torch.Tensor        # (6,)


# constant selector matrices for the JAX module's `.at[].set` writes
_EE_ANG_EULER = np.zeros((6, NQ), dtype=bool)
_EE_ANG_EULER[3:, 3:6] = True                 # ee_dJ[3:, 3:6] = 0
_EULER_COLS3 = np.zeros((3, NQ), dtype=bool)
_EULER_COLS3[:, 3:6] = True                   # Jang[:, 3:6] = 0
_SEL_Z = np.zeros((1, NUM_DECISION_VARS)); _SEL_Z[0, 2] = 1.0
_SEL_XY = np.zeros((2, NUM_DECISION_VARS)); _SEL_XY[0, 0] = _SEL_XY[1, 1] = 1.0
_SEL_ARM = np.zeros((6, NUM_DECISION_VARS)); _SEL_ARM[:, 18:24] = np.eye(6)
_SEL_FORCE = np.zeros((12, NUM_DECISION_VARS))
_SEL_FORCE[:, 24:] = np.eye(12)
_EYE12 = np.eye(12)
_PYRAMID = np.array([[0.0, 0.0, -1.0],
                     [1.0, 0.0, 0.0],
                     [-1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0],
                     [0.0, -1.0, 0.0]])
_PYRAMID_MU = np.zeros((5, 3)); _PYRAMID_MU[1:, 2] = 1.0   # pyr[1:, 2] = -mu


def _vec(val, like):
    """A gain given as a float, a tuple or a tensor, on like's device."""
    if isinstance(val, torch.Tensor):
        return val.to(dtype=like.dtype, device=like.device)
    if isinstance(val, (tuple, list, np.ndarray)):
        return const(val, like)
    return val


def _measured_from_suite(q, v, contact_flags, s, ds):
    """WbcData from an RbdSuite and its q-Jacobian (ds) by contraction."""
    dM = ds.M                                      # (24,24,24)
    Mdot = torch.einsum("ijk,k->ij", dM, v)
    dTdq = 0.5 * torch.einsum("i,ijk,j->k", v, dM, v)
    h = Mdot @ v - dTdq + s.gvec
    dJc_v = torch.einsum("ijk,k,j->i", ds.Jc, v, v)
    base_dJ_v = torch.einsum("ijk,k,j->i", ds.base_J, v, v)
    ee_dJ = torch.einsum("ijk,k->ij", ds.ee_J, v)  # (6,24)
    ee_dJ_noeuler = torch.where(const(_EE_ANG_EULER, q, torch.bool),
                                torch.zeros_like(ee_dJ), ee_dJ)
    feet_vel = (s.Jc @ v).reshape(4, 3)
    return WbcData(q=q, v=v, M=s.M, h=h, Jc=s.Jc, dJc_v=dJc_v,
                   base_J=s.base_J, base_dJ_v=base_dJ_v,
                   ee_J=s.ee_J, ee_dJ_v=ee_dJ @ v,
                   ee_dJ_v_noeuler=(ee_dJ_noeuler @ v)[3:],
                   feet_pos=s.feet_pos, feet_vel=feet_vel,
                   ee_pos=s.ee_pos, ee_R=s.ee_R, ee_vel=s.ee_J @ v,
                   contact_flags=torch.as_tensor(contact_flags).to(q))


def compute_measured(model: RobotModel, q, v, contact_flags) -> WbcData:
    """The measured side alone (reference WbcBase.cpp:134-191): one
    rbd_suite evaluation and one 24-tangent jacfwd of it."""
    def suite(qq):
        return D.rbd_suite(model, qq)
    return _measured_from_suite(q, v, contact_flags, suite(q),
                                jacfwd(suite)(q))


def compute_wbc_data(model: RobotModel, info: C.CentroidalInfo,
                     state_des, input_des, input_last, q, v,
                     contact_flags, period):
    """(WbcData, WbcDesired): one vmapped (rbd_suite, jacfwd(rbd_suite))
    over the stacked [q_meas, q_des], as in the JAX module."""
    q_des = C.state_to_q(state_des)
    v_base = C.base_velocity_from_momentum(info, state_des)
    v_des = torch.cat([v_base, input_des[12:]])

    def suite_twice(qq):
        s = D.rbd_suite(model, qq)
        return s, s

    jacs, prims = vmap(jacfwd(suite_twice, has_aux=True))(
        torch.stack([q, q_des]))
    s0 = type(prims)(*[a[0] for a in prims])
    ds0 = type(jacs)(*[a[0] for a in jacs])
    s1 = type(prims)(*[a[1] for a in prims])
    ds1 = type(jacs)(*[a[1] for a in jacs])

    m = _measured_from_suite(q, v, contact_flags, s0, ds0)

    # desired side (reference WbcBase::updateDesired :193-226)
    joint_acc = (input_des[12:] - input_last[12:]) / period
    A = s1.A
    Adot = torch.einsum("ijk,k->ij", ds1.A, v_des)
    Ab, Aj = A[:, :6], A[:, 6:]
    hdot = C.flow_map(model, info, state_des, input_des)[:6] * info.mass
    rate = hdot - Adot @ v_des - Aj @ joint_acc
    # solve_ex: no host-side singularity check (keeps the tick asynchronous)
    base_acc = torch.linalg.solve_ex(Ab, rate)[0]
    feet_vel = (s1.Jc @ v_des).reshape(4, 3)
    d = WbcDesired(q=q_des, v=v_des, base_acc=base_acc,
                   feet_pos=s1.feet_pos, feet_vel=feet_vel,
                   ee_pos=s1.ee_pos, ee_R=s1.ee_R, ee_vel=s1.ee_J @ v_des)
    return m, d


def compute_desired(model: RobotModel, info: C.CentroidalInfo,
                    state_des, input_des, input_last, period) -> WbcDesired:
    """The desired side alone (reference WbcBase::updateDesired :193-226):
    the base acceleration Ab^-1 (m hdot_des - Adot v - Aj qdd_j), joint
    accelerations differenced from consecutive MPC inputs; one jvp gives
    A and Adot together."""
    q_des = C.state_to_q(state_des)
    v_base = C.base_velocity_from_momentum(info, state_des)
    v_des = torch.cat([v_base, input_des[12:]])
    joint_acc = (input_des[12:] - input_last[12:]) / period
    A, Adot = jvp(lambda qq: D.centroidal_momentum_matrix(model, qq),
                  (q_des,), (v_des,))
    Ab, Aj = A[:, :6], A[:, 6:]
    hdot = C.flow_map(model, info, state_des, input_des)[:6] * info.mass
    rate = hdot - Adot @ v_des - Aj @ joint_acc
    base_acc = torch.linalg.solve_ex(Ab, rate)[0]
    Jc, _, ee_J, feet_pos, ee_pos, ee_R = K.frame_kinematics(model, q_des)
    return WbcDesired(q=q_des, v=v_des, base_acc=base_acc,
                      feet_pos=feet_pos, feet_vel=(Jc @ v_des).reshape(4, 3),
                      ee_pos=ee_pos, ee_R=ee_R, ee_vel=ee_J @ v_des)


# ---------------------------------------------------------------------------
# task formulations (reference WbcBase.cpp:228-546). x = [v_dot(24); F(12)]
# ---------------------------------------------------------------------------

def _with_force_cols(A_vdot, A_force):
    return torch.cat([A_vdot, A_force], dim=1)


def _ee_generalized_force(m: WbcData, ee_wrench):
    """Q = J_ee^T w (24,) for a world wrench [f(3); tau(3)] at the arm EE;
    zeros when no wrench is given."""
    if ee_wrench is None:
        return torch.zeros_like(m.q)
    return m.ee_J.T @ torch.as_tensor(ee_wrench).to(m.q)


def floating_base_eom_task(m: WbcData, ee_wrench=None) -> Task:
    """[Mb, -Jb'] x = -hb + (J_ee' w)[:6] (reference :338-356)."""
    A = _with_force_cols(m.M[:6], -m.Jc.T[:6])
    Q = _ee_generalized_force(m, ee_wrench)
    return eq_task(A, -m.h[:6] + Q[:6])


def torque_limits_task(m: WbcData, tau_max, ee_wrench=None) -> Task:
    """+-[Mj, -Jj'] x <= tau_max -+ (hj - (J_ee' w)[6:]) (reference
    :360-383)."""
    Aj = _with_force_cols(m.M[6:], -m.Jc.T[6:])
    D_ = torch.cat([Aj, -Aj], dim=0)
    tau = _vec(tau_max, m.q)
    Q = _ee_generalized_force(m, ee_wrench)
    hj_eff = m.h[6:] - Q[6:]
    return ineq_task(D_, torch.cat([tau - hj_eff, tau + hj_eff]))


def no_contact_motion_task(m: WbcData) -> Task:
    """Jc x = -dJc v for stance feet (reference :386-401); swing rows
    masked to 0 = 0."""
    mask = torch.repeat_interleave(m.contact_flags, 3)
    A = _with_force_cols(m.Jc, m.q.new_zeros((12, 12)))
    return eq_task(A * mask[:, None], -m.dJc_v * mask)


def friction_cone_task(m: WbcData, friction_coeff) -> Task:
    """Swing feet: F = 0 (equality). Stance feet: 5-face pyramid
    D F <= 0 (reference :407-437). Masked rows: equalities -> 0 = 0;
    inequalities -> 0 <= BIG."""
    c = m.contact_flags
    swing_mask = torch.repeat_interleave(1.0 - c, 3)
    A_force = const(_EYE12, m.q) * swing_mask[:, None]
    A = _with_force_cols(m.q.new_zeros((12, 24)), A_force)
    b = m.q.new_zeros(12)
    pyr = const(_PYRAMID, m.q) - friction_coeff * const(_PYRAMID_MU, m.q)
    D_force = torch.block_diag(pyr, pyr, pyr, pyr) \
        * torch.repeat_interleave(c, 5)[:, None]              # (20,12)
    D_ = _with_force_cols(m.q.new_zeros((20, 24)), D_force)
    f = torch.repeat_interleave(1.0 - c, 5) * MASK_BIG        # inactive->BIG
    return Task(A, b, D_, f)


def base_height_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """z acceleration servo (reference :296-308)."""
    b = (d.base_acc[2] + kp * (d.q[2] - m.q[2]) + kd * (d.v[2] - m.v[2]))
    return eq_task(const(_SEL_Z, m.q), b[None])


def base_linear_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """xy acceleration + position/velocity servo (reference :228-240)."""
    b = (d.base_acc[:2] + kp * (d.q[:2] - m.q[:2])
         + kd * (d.v[:2] - m.v[:2]))
    return eq_task(const(_SEL_XY, m.q), b)


def base_xy_accel_task(m: WbcData, d: WbcDesired) -> Task:
    """Feedforward-only xy acceleration (reference :243-255)."""
    return eq_task(const(_SEL_XY, m.q), d.base_acc[:2])


def base_angular_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """World-frame angular acceleration servo through the base angular
    Jacobian (reference :258-293)."""
    A = _with_force_cols(m.base_J[3:], m.q.new_zeros((3, 12)))
    E_meas = euler_zyx_rate_to_omega_world_matrix(m.q[3:6])
    omega_meas = E_meas @ m.v[3:6]
    omega_des = E_meas @ d.v[3:6]        # reference uses measured angles
    R_meas = euler_zyx_to_R(m.q[3:6])
    R_des = euler_zyx_to_R(d.q[3:6])
    err = rotation_error_world(R_des, R_meas)
    # desired angular acceleration: d/dt(E(zyx) zyx_dot) along desired rates
    _, Edot_v = jvp(lambda z: euler_zyx_rate_to_omega_world_matrix(z)
                    @ d.v[3:6], (m.q[3:6],), (d.v[3:6],))
    acc_des = E_meas @ d.base_acc[3:6] + Edot_v
    b = acc_des + kp * err + kd * (omega_des - omega_meas) - m.base_dJ_v[3:]
    return eq_task(A, b)


def swing_leg_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """Cartesian PD on swing feet (reference :311-334); stance rows
    masked."""
    mask = torch.repeat_interleave(1.0 - m.contact_flags, 3)
    accel = (kp * (d.feet_pos - m.feet_pos)
             + kd * (d.feet_vel - m.feet_vel)).reshape(-1)
    A = _with_force_cols(m.Jc, m.q.new_zeros((12, 12)))
    b = accel - m.dJc_v
    return eq_task(A * mask[:, None], b * mask)


def arm_joint_tracking_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """Arm joint PD (reference :439-465); the arm-settling stage."""
    kp, kd = _vec(kp, m.q), _vec(kd, m.q)
    b = kp * (d.q[18:24] - m.q[18:24]) + kd * (d.v[18:24] - m.v[18:24])
    return eq_task(const(_SEL_ARM, m.q), b)


def ee_linear_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """Arm-EE linear Cartesian PD in world frame (reference :467-492)."""
    A = _with_force_cols(m.ee_J[:3], m.q.new_zeros((3, 12)))
    kp, kd = _vec(kp, m.q), _vec(kd, m.q)
    acc = kp * (d.ee_pos - m.ee_pos) + kd * (d.ee_vel[:3] - m.ee_vel[:3])
    return eq_task(A, acc - m.ee_dJ_v[:3])


def ee_angular_task(m: WbcData, d: WbcDesired, kp, kd) -> Task:
    """Arm-EE angular tracking with world rotation error; base-Euler
    columns zeroed as in the reference (:494-531; damping only)."""
    Jang = torch.where(const(_EULER_COLS3, m.q, torch.bool),
                       torch.zeros_like(m.ee_J[3:]), m.ee_J[3:])
    A = _with_force_cols(Jang, m.q.new_zeros((3, 12)))
    err = rotation_error_world(d.ee_R, m.ee_R)
    kp, kd = _vec(kp, m.q), _vec(kd, m.q)
    b = kp * err + kd * (-m.ee_vel[3:]) - m.ee_dJ_v_noeuler
    return eq_task(A, b)


def contact_force_task(m: WbcData, input_des) -> Task:
    """F = F_mpc for all four feet (reference :534-546)."""
    return eq_task(const(_SEL_FORCE, m.q), input_des[:12])


def recover_torques(m: WbcData, x_opt, ee_wrench=None):
    """tau = Mj vdot - Jj' F + hj - (J_ee' w)[6:] (reference
    WbcBase::updateCmd :548-563)."""
    vdot, F = x_opt[:24], x_opt[24:]
    Q = _ee_generalized_force(m, ee_wrench)
    return m.M[6:] @ vdot - m.Jc.T[6:] @ F + m.h[6:] - Q[6:]
