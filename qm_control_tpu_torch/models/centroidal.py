"""Centroidal (single-rigid-body) model (port of
qm_control_tpu/models/centroidal.py).

State / input layout as in the JAX module:
  x in R^30 = [ h_norm(6) = (v_com, L_world/m) ; base pose (p(3), zyx(3)) ;
               q_joints(18) ]
  u in R^30 = [ contact forces 4x3 (LF, RF, LH, RH, world) ; qdot_j(18) ]

The MPC linearizes through ocp/linearize.py; `linearize_flow_map` is the
autodiff Jacobian pair of the JAX module.
"""
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from . import dynamics as D
from . import kinematics as K
from ._const import const
from ._fwd import jacfwd
from .rotations import euler_zyx_rate_to_omega_world_matrix, euler_zyx_to_R
from .smallmat import mm3, mv3
from .spec import NQ, NUM_CONTACTS, NUM_JOINTS, RobotModel, default_q

STATE_DIM = 30
INPUT_DIM = 30
GRAVITY = D.GRAVITY
_GRAVITY_VEC = np.array([0.0, 0.0, -GRAVITY])


@dataclass(frozen=True)
class CentroidalInfo:
    """Frozen SRBD quantities (nominal joint configuration)."""
    mass: float
    r_com_base: np.ndarray      # COM offset from base origin, base frame (3,)
    I_com_base: np.ndarray      # centroidal inertia, base frame (3,3)


def make_centroidal_info(model: RobotModel, q_nominal=None) -> CentroidalInfo:
    """SRBD constants at the nominal configuration, computed in f32 on the
    CPU (as the JAX package computes them); the result is numpy."""
    if q_nominal is None:
        q_nominal = default_q(base_pos=(0, 0, 0), base_zyx=(0, 0, 0))
    q = torch.as_tensor(np.asarray(q_nominal), dtype=torch.float32)
    com = D.com_position(model, q).numpy()
    A = D.centroidal_momentum_matrix(model, q).numpy()
    E0 = euler_zyx_rate_to_omega_world_matrix(q[3:6]).numpy()
    I_com = A[3:, 3:6] @ np.linalg.inv(E0)
    assert np.allclose(I_com, I_com.T, atol=1e-4), I_com
    return CentroidalInfo(mass=float(model.total_mass),
                          r_com_base=com, I_com_base=np.asarray(I_com))


def state_to_q(x):
    """Generalized coordinates q(24) from centroidal state x(30)."""
    return x[6:6 + NQ]


def base_velocity_from_momentum(info: CentroidalInfo, x):
    """[pdot_base(3); zyx_rates(3)] from normalized momentum (SRBD)."""
    from . import chainfk
    return chainfk.base_velocity_from_momentum(info, x)


def com_position_srbd(info: CentroidalInfo, x):
    """SRBD COM: base position + rotated nominal offset."""
    R = euler_zyx_to_R(x[9:12])
    return x[6:9] + mv3(R, const(info.r_com_base, x))


def flow_map(model: RobotModel, info: CentroidalInfo, x, u, ee_wrench=None):
    """xdot = f(x, u): centroidal dynamics (reference QMDynamicsAD flow
    map): momentum rate from contact forces + gravity, base pose rate from
    the frozen SRBD momentum matrix, joint rate = commanded joint velocity.
    ee_wrench: optional world wrench [f(3); tau(3)] applied at the arm EE
    (the disturbance-aware MPC dynamics, BASELINE config #4)."""
    q = state_to_q(x)
    forces = u[:3 * NUM_CONTACTS].reshape(NUM_CONTACTS, 3)
    v_j = u[3 * NUM_CONTACTS:]
    p_contacts = K.contact_positions(model, q)
    p_com = com_position_srbd(info, x)
    f_total = forces.sum(0)
    tau_com = torch.linalg.cross(p_contacts - p_com[None, :], forces).sum(0)
    if ee_wrench is not None:
        from ..ocp.costs import ee_pose
        w = torch.as_tensor(ee_wrench, dtype=x.dtype, device=x.device)
        p_ee, _ = ee_pose(model, q)
        f_total = f_total + w[:3]
        tau_com = tau_com + torch.linalg.cross(p_ee - p_com, w[:3]) + w[3:]
    h_dot_lin = f_total / info.mass + const(_GRAVITY_VEC, x)
    h_dot_ang = tau_com / info.mass
    base_dot = base_velocity_from_momentum(info, x)
    return torch.cat([h_dot_lin, h_dot_ang, base_dot, v_j])


def linearize_flow_map(model: RobotModel, info: CentroidalInfo, x, u):
    """A = df/dx (30x30), B = df/du (30x30) by forward-mode autodiff
    (reference QMDynamicsAD::linearApproximation). torch.func's forward
    mode may widen tangents to float64 (models/_const.scalar), so the
    Jacobians are cast to x's dtype."""
    f = partial(flow_map, model, info)
    A = jacfwd(f, argnums=0)(x, u)
    B = jacfwd(f, argnums=1)(x, u)
    return A.to(x.dtype), B.to(x.dtype)


def weight_compensating_input(info: CentroidalInfo, contact_flags):
    """Gravity-distributing input for the given contact flags (reference
    OCS2 weightCompensatingInput, QMInitializer.cpp:35-40)."""
    flags = torch.as_tensor(contact_flags)
    n_active = torch.clamp(flags.sum(), min=1)
    fz = info.mass * GRAVITY / n_active
    f32 = flags.to(torch.float32)
    forces = torch.stack([torch.zeros_like(f32), torch.zeros_like(f32),
                          f32 * fz], dim=1)                      # (4,3)
    return torch.cat([forces.reshape(-1),
                      torch.zeros(NUM_JOINTS, dtype=torch.float32,
                                  device=flags.device)])


def centroidal_state_from_rbd(model: RobotModel, info: CentroidalInfo, q, v):
    """x(30) from generalized (q, v) using the SRBD momentum matrix."""
    zyx = q[3:6]
    R = euler_zyx_to_R(zyx)
    E = euler_zyx_rate_to_omega_world_matrix(zyx)
    omega = mv3(E, v[3:6])
    r_w = mv3(R, const(info.r_com_base, q))
    v_com = v[0:3] + torch.linalg.cross(omega, r_w)
    I_w = mm3(mm3(R, const(info.I_com_base, q)), R.transpose(-1, -2))
    l_norm = mv3(I_w, omega) / info.mass
    return torch.cat([v_com, l_norm, q])


def rbd_velocity_from_centroidal(info: CentroidalInfo, x, v_joints=None):
    """v(24) from centroidal state (joint rates must be supplied or zero)."""
    if v_joints is None:
        v_joints = x.new_zeros(NUM_JOINTS)
    return torch.cat([base_velocity_from_momentum(info, x), v_joints])


def full_centroidal_state_from_rbd(model: RobotModel, q, v):
    """x(30) using the exact (full) centroidal momentum matrix A(q) v: the
    FullCentroidalDynamics variant (centroidalModelType 0) mapping."""
    h_norm = (D.centroidal_momentum_matrix(model, q) @ v) / model.total_mass
    return torch.cat([h_norm, q])
