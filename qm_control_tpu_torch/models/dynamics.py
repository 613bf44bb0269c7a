"""Rigid-body dynamics (port of qm_control_tpu/models/dynamics.py).

Energy-consistent autodiff formulation, as in the JAX module:

  M(q)      = sum_b J_b^T I_b^world J_b
  g(q)      = grad_q V(q),  V = sum_b m_b g z_com_b
  h(q,v)    = Mdot v - 1/2 grad_q (v^T M v) + g(q)
  A(q)      = sum_b T_b I_b^world J_b          (centroidal momentum matrix)

Mdot and Adot come from torch.func.jvp along v, the gradients from
torch.func.jacfwd (forward mode, as the JAX module chose), so M and h
derive from the same kinetic energy.
"""
from functools import partial
from typing import NamedTuple

import torch

from ._const import const
from ._fwd import jacfwd, jvp
from .kinematics import all_body_jacobians, fk, frame_kinematics, _static
from .rotations import skew
from .spec import RobotModel

GRAVITY = 9.81


def _world_spatial_inertias(model: RobotModel, cache):
    """(n,6,6) spatial inertia of each body about its frame origin, world
    axes, ordering [linear; angular]."""
    R = cache["R"]
    m = const(model.mass, R)
    c_w = torch.einsum("nij,nj->ni", R, const(model.com, R))
    Ic_w = torch.einsum("nij,njk,nlk->nil", R, const(model.inertia, R), R)
    S = skew(c_w)
    eye = const(_static(model)["eye"], R).expand(S.shape)
    mm = m[:, None, None]
    top = torch.cat([mm * eye, -mm * S], dim=2)
    bot = torch.cat([mm * S, Ic_w - mm * (S @ S)], dim=2)
    return torch.cat([top, bot], dim=1)


def _com_world(model: RobotModel, cache):
    return cache["p"] + torch.einsum("nij,nj->ni", cache["R"],
                                     const(model.com, cache["R"]))


def mass_matrix(model: RobotModel, q):
    """(nq, nq) joint-space inertia matrix (reference: pinocchio::crba)."""
    cache = fk(model, q)
    J = all_body_jacobians(model, cache)
    I = _world_spatial_inertias(model, cache)
    M = torch.einsum("nik,nij,njl->kl", J, I, J)
    return 0.5 * (M + M.T)


def potential_energy(model: RobotModel, q):
    c_w = _com_world(model, fk(model, q))
    # the constant as a tensor (filled on the device, no host copy): under
    # torch.func.jacfwd a Python float times a 0-dim tensor promotes the
    # derivative to float64
    return torch.sum(const(model.mass, q) * c_w[:, 2]) * q.new_full((), GRAVITY)


def gravity_vector(model: RobotModel, q):
    return jacfwd(partial(potential_energy, model))(q)


def kinetic_energy(model: RobotModel, q, v):
    return 0.5 * v @ mass_matrix(model, q) @ v


def nonlinear_effects(model: RobotModel, q, v):
    """h(q,v) = C(q,v)v + g(q) (reference: pinocchio::nonLinearEffects)."""
    _, Mdot = jvp(partial(mass_matrix, model), (q,), (v,))
    dTdq = jacfwd(lambda qq: kinetic_energy(model, qq, v))(q)
    return Mdot @ v - dTdq + gravity_vector(model, q)


def com_position(model: RobotModel, q):
    m = const(model.mass, q)
    c_w = _com_world(model, fk(model, q))
    return (m[:, None] * c_w).sum(0) / m.sum()


def _cmm(model: RobotModel, q, cache, J, I):
    m = const(model.mass, q)
    c_w = _com_world(model, cache)
    com = (m[:, None] * c_w).sum(0) / m.sum()
    # momentum of body b about its origin -> about the com
    S = skew(cache["p"] - com[None, :])
    eye = const(_static(model)["eye"], q).expand(S.shape)
    zero = torch.zeros_like(S)
    T = torch.cat([torch.cat([eye, zero], dim=2),
                   torch.cat([S, eye], dim=2)], dim=1)          # (n,6,6)
    return torch.einsum("nij,njk,nkl->il", T, I, J), c_w


def centroidal_momentum_matrix(model: RobotModel, q):
    """(6, nq) A(q) with h_com = A(q) v, [linear; angular] about the COM."""
    cache = fk(model, q)
    J = all_body_jacobians(model, cache)
    I = _world_spatial_inertias(model, cache)
    return _cmm(model, q, cache, J, I)[0]


def centroidal_momentum_matrix_dot(model: RobotModel, q, v):
    """dA/dt via jvp (reference: pinocchio::dccrba)."""
    _, Adot = jvp(partial(centroidal_momentum_matrix, model), (q,), (v,))
    return Adot


class RbdSuite(NamedTuple):
    """Every RBD/frame quantity the WBC needs from ONE FK pass; jacfwd of
    rbd_suite gives all the time-derivative terms by contraction."""
    M: torch.Tensor        # (24,24) mass matrix
    A: torch.Tensor        # (6,24) centroidal momentum matrix
    Jc: torch.Tensor       # (12,24) stacked contact Jacobian (linear)
    base_J: torch.Tensor   # (6,24)
    ee_J: torch.Tensor     # (6,24)
    feet_pos: torch.Tensor  # (4,3)
    ee_pos: torch.Tensor   # (3,)
    ee_R: torch.Tensor     # (3,3)
    gvec: torch.Tensor     # (24,) gravity generalized force (analytic)


def rbd_suite(model: RobotModel, q) -> RbdSuite:
    """One FK pass -> (M, A, frame Jacobians, closed-form gravity)."""
    cache = fk(model, q)
    J = all_body_jacobians(model, cache)
    I = _world_spatial_inertias(model, cache)
    M = torch.einsum("nik,nij,njl->kl", J, I, J)
    M = 0.5 * (M + M.T)
    A, c_w = _cmm(model, q, cache, J, I)

    # analytic gravity: z-row of each body-com point Jacobian
    a, o = cache["a"], cache["o"]                      # (k,3)
    rev = const(_static(model)["rev"], q)              # (k,)
    mask = const(model.ancestor, q)                    # (k,b)
    rc = c_w[None, :, :] - o[:, None, :]               # (k,b,3)
    cross_z = a[:, None, 0] * rc[:, :, 1] - a[:, None, 1] * rc[:, :, 0]
    lin_z = rev[:, None] * cross_z + (1.0 - rev)[:, None] * a[:, None, 2]
    gvec = GRAVITY * torch.einsum("b,kb->k", const(model.mass, q),
                                  lin_z * mask)

    Jc, base_J, ee_J, feet_pos, ee_pos, ee_R = frame_kinematics(
        model, q, cache=cache)
    return RbdSuite(M=M, A=A, Jc=Jc, base_J=base_J, ee_J=ee_J,
                    feet_pos=feet_pos, ee_pos=ee_pos, ee_R=ee_R, gvec=gvec)


def forward_dynamics(model: RobotModel, q, v, tau, J_c=None, f_c=None):
    """v_dot = M^{-1} (tau + J_c^T f_c - h). tau is the full (nq,) force."""
    rhs = tau - nonlinear_effects(model, q, v)
    if J_c is not None:
        rhs = rhs + J_c.T @ f_c
    # solve_ex: no host-side singularity check
    return torch.linalg.solve_ex(mass_matrix(model, q), rhs)[0]
