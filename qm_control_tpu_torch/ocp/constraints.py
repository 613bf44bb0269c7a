"""State-input equality constraints by input reparameterization (port of
qm_control_tpu/ocp/constraints.py).

The reference imposes, per foot (QMInterface.cpp:116-131): in stance zero
foot velocity; in swing zero contact force and the foot's normal velocity
equal to its reference. They are eliminated analytically,

    u = u0(x, t) + N(x, t) @ w,        w in R^30 (same layout as u),

because each foot's constraints touch only that leg's 3 joint velocities:
a stance leg's velocity is pinned by a damped 3x3 solve and its forces are
free; a swing leg's forces are pinned to 0 and the rank-2 projector
P = I - a a^T/|a|^2 (a = z-row of the leg Jacobian) leaves its tangential
motion free. Contact flags enter as float masks. (u0, N) are assembled by
concatenation, never by in-place writes, so the map runs under
torch.func.vmap and jacfwd.
"""
from typing import NamedTuple

import numpy as np
import torch

from ..models import centroidal as C
from ..models import chainfk
from ..models.smallmat import mm3, mtv3, solve3
from ..models.spec import CONTACT_LEG_JOINTS, RobotModel

_DAMP = 1e-6
# feet (LF, RF, LH, RH) -> joint-order leg blocks (LF, LH, RF, RH):
# FOOT_FOR_BLOCK[b] is the foot whose 3 joint velocities sit at block b
FOOT_FOR_BLOCK = tuple(int(f) for f in np.argsort(
    [CONTACT_LEG_JOINTS[f][0] for f in range(4)]))


class InputParam(NamedTuple):
    """u = u0 + N @ w at one (x, t) query."""
    u0: torch.Tensor    # (30,)
    N: torch.Tensor     # (30, 30)


def _foot_jacobians(model: RobotModel, q):
    """Per-foot linear Jacobian split: (4,3,6) base cols, (4,3,3) own-leg
    cols (scalar-structured leg chains, models/chainfk.py)."""
    _, Jb, Jl = chainfk.foot_kinematics(model, q)
    return Jb, Jl


def _damped_solve(A, b):
    """x with A x ~= b for (possibly singular) 3x3 A: A^T(AA^T + eps I)^-1 b."""
    AAt = mm3(A, A.transpose(-1, -2)) \
        + _DAMP * torch.eye(3, dtype=A.dtype, device=A.device)
    return mtv3(A, solve3(AAt, b))


def leg_blocks(rows):
    """(4, 3) per-foot rows -> (12,) in joint order."""
    return torch.cat([rows[f] for f in FOOT_FOR_BLOCK])


def swing_projectors(a):
    """(P (4,3,3), |a|^2 + damp (4,)) of the swing-leg z-rows a (4,3)."""
    aa = torch.sum(a * a, dim=1) + _DAMP
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(4, 3, 3)
    return eye - a[:, :, None] * a[:, None, :] / aa[:, None, None], aa


def leg_null_block(c, P_swing):
    """(12,12) block-diagonal swing projector of the leg-velocity slots:
    block b = (1 - c[f]) P_swing[f] for f = FOOT_FOR_BLOCK[b]."""
    z3 = torch.zeros(3, 3, dtype=P_swing.dtype, device=P_swing.device)
    rows = []
    for b in range(4):
        f = FOOT_FOR_BLOCK[b]
        row = [z3] * 4
        row[b] = (1.0 - c[f]) * P_swing[f]
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)


def input_parameterization(model: RobotModel, info: C.CentroidalInfo,
                           x, contact_flags, swing_zdot_ref) -> InputParam:
    """(u0, N) at state x for contact flags (4,) in {0,1} and per-foot
    swing normal-velocity references (4,). positionErrorGain = 0
    (task.info:11): the normal-velocity constraint has no position term."""
    dtype, dev = x.dtype, x.device
    q = C.state_to_q(x)
    base_dot = C.base_velocity_from_momentum(info, x)            # (6,)
    Jb, Jl = _foot_jacobians(model, q)                           # (4,3,6),(4,3,3)
    c = torch.as_tensor(contact_flags, dtype=dtype, device=dev)  # (4,)

    # stance: u_leg = -Jl^-1 Jb base_dot  (damped)
    rhs = -torch.einsum("fij,j->fi", Jb, base_dot)
    u_stance = _damped_solve(Jl, rhs)
    # swing: a.u_leg = b, a = z-row of Jl, b = zdot_ref - z-row(Jb).base_dot
    a = Jl[:, 2, :]
    b = swing_zdot_ref - Jb[:, 2, :] @ base_dot
    P_swing, aa = swing_projectors(a)
    u_swing = a * (b / aa)[:, None]

    u0_legs = c[:, None] * u_stance + (1.0 - c[:, None]) * u_swing
    u0 = torch.cat([torch.zeros(12, dtype=dtype, device=dev),
                    leg_blocks(u0_legs),
                    torch.zeros(6, dtype=dtype, device=dev)])
    cf12 = torch.repeat_interleave(c, 3)
    Nl = leg_null_block(c, P_swing)
    z = lambda r, k: torch.zeros(r, k, dtype=dtype, device=dev)
    N = torch.cat([
        torch.cat([torch.diag_embed(cf12), z(12, 18)], dim=1),
        torch.cat([z(12, 12), Nl, z(12, 6)], dim=1),
        torch.cat([z(6, 24), torch.eye(6, dtype=dtype, device=dev)], dim=1)],
        dim=0)
    return InputParam(u0=u0, N=N)


def apply_input_param(p: InputParam, w):
    return p.u0 + p.N @ w


def constraint_residuals(model: RobotModel, info: C.CentroidalInfo,
                         x, u, contact_flags, swing_zdot_ref):
    """Masked residuals (zero when inactive) of the three constraint
    families at (x, u): zero_velocity (4,3), zero_force (4,3),
    normal_velocity (4,). For tests and diagnostics."""
    dtype = x.dtype
    q = C.state_to_q(x)
    base_dot = C.base_velocity_from_momentum(info, x)
    Jb, Jl = _foot_jacobians(model, q)
    c = torch.as_tensor(contact_flags, dtype=dtype, device=x.device)
    forces = u[:12].reshape(4, 3)
    u_legs = torch.stack([u[12 + CONTACT_LEG_JOINTS[f][0]:
                            12 + CONTACT_LEG_JOINTS[f][0] + 3]
                          for f in range(4)])
    v_feet = torch.einsum("fij,j->fi", Jb, base_dot) \
        + torch.einsum("fij,fj->fi", Jl, u_legs)
    return dict(
        zero_velocity=c[:, None] * v_feet,
        zero_force=(1.0 - c[:, None]) * forces,
        normal_velocity=(1.0 - c) * (v_feet[:, 2] - swing_zdot_ref),
    )
