"""Scalar-structured leg-chain kinematics (port of
qm_control_tpu/models/chainfk.py).

Rotations are 9 named scalars (R9), and the robot's verified structure is
used: every leg joint origin has identity rotation, the axes are HAA = x,
HFE = y, KFE = y (two y-rotations collapse), and the four legs evaluate
lane-parallel as (4,)-vectors. Products with zero entries of constant
matrices are skipped, as in the JAX module, so both packages add the same
terms in the same order.

The arm chain (kinova j2n6s300) has constant origin rotations and all
joint axes z. `foot_kinematics` (foot positions with their Jacobian
blocks) and `ee_pose` serve the MPC's input map, linearization and costs.
"""
from typing import NamedTuple

import numpy as np
import torch

from ._const import const, scalar
from .spec import (CONTACT_FRAMES, CONTACT_LEG_JOINTS, EE_FRAME, NUM_BASE,
                   NUM_LEG_JOINTS, REVOLUTE, RobotModel)


class R9(NamedTuple):
    """Rotation matrix as 9 scalars (each may carry leading batch dims)."""
    r00: object; r01: object; r02: object
    r10: object; r11: object; r12: object
    r20: object; r21: object; r22: object

    def col(self, j):
        r = self
        return ((r.r00, r.r10, r.r20), (r.r01, r.r11, r.r21),
                (r.r02, r.r12, r.r22))[j]

    def to_mat(self):
        r = self
        return torch.stack([stack3((r.r00, r.r01, r.r02)),
                            stack3((r.r10, r.r11, r.r12)),
                            stack3((r.r20, r.r21, r.r22))], dim=-2)


def from_euler_zyx(zyx):
    """R = Rz(yaw) Ry(pitch) Rx(roll) as R9."""
    cz, sz = torch.cos(zyx[..., 0]), torch.sin(zyx[..., 0])
    cy, sy = torch.cos(zyx[..., 1]), torch.sin(zyx[..., 1])
    cx, sx = torch.cos(zyx[..., 2]), torch.sin(zyx[..., 2])
    return R9(cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
              sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
              -sy, cy * sx, cy * cx)


def _dot_const(row, v, vt=None):
    """sum_i row[i] * v[i] for constant numpy v, skipping exact zeros.
    v holds scalars, or (B,) columns whose tensor copies are vt[i]."""
    acc = None
    for i, (ri, vi) in enumerate(zip(row, v)):
        vi_arr = np.asarray(vi)
        if np.all(vi_arr == 0.0):
            continue
        term = ri * (scalar(vi, ri) if vi_arr.ndim == 0 else vt[i])
        acc = term if acc is None else acc + term
    if acc is None:
        return row[0] * scalar(0.0, row[0])
    return acc


def rotv_const(R: R9, v):
    """R @ v for a constant numpy v (3,) or a persistent (B,3) array —
    zeros skipped."""
    v = np.asarray(v)
    if v.ndim == 2:
        cols, vt = (v[:, 0], v[:, 1], v[:, 2]), const(v, R.r00).T
    else:
        cols, vt = (v[0], v[1], v[2]), None
    return (_dot_const((R.r00, R.r01, R.r02), cols, vt),
            _dot_const((R.r10, R.r11, R.r12), cols, vt),
            _dot_const((R.r20, R.r21, R.r22), cols, vt))


def rotv(R: R9, v):
    """R @ v for a 3-tuple of scalars v."""
    vx, vy, vz = v
    return (R.r00 * vx + R.r01 * vy + R.r02 * vz,
            R.r10 * vx + R.r11 * vy + R.r12 * vz,
            R.r20 * vx + R.r21 * vy + R.r22 * vz)


def rott_v(R: R9, v):
    """R^T @ v."""
    vx, vy, vz = v
    return (R.r00 * vx + R.r10 * vy + R.r20 * vz,
            R.r01 * vx + R.r11 * vy + R.r21 * vz,
            R.r02 * vx + R.r12 * vy + R.r22 * vz)


def mul_const(R: R9, M):
    """R @ M for a constant numpy 3x3 M (zeros skipped)."""
    M = np.asarray(M)
    rows = ((R.r00, R.r01, R.r02), (R.r10, R.r11, R.r12),
            (R.r20, R.r21, R.r22))
    return R9(*[_dot_const(rows[i], (M[0, j], M[1, j], M[2, j]))
                for i in range(3) for j in range(3)])


def mul_rx(R: R9, ang):
    """R @ Rx(ang): mixes columns 1, 2."""
    c, s = torch.cos(ang), torch.sin(ang)
    return R9(R.r00, R.r01 * c + R.r02 * s, -R.r01 * s + R.r02 * c,
              R.r10, R.r11 * c + R.r12 * s, -R.r11 * s + R.r12 * c,
              R.r20, R.r21 * c + R.r22 * s, -R.r21 * s + R.r22 * c)


def mul_ry(R: R9, ang):
    """R @ Ry(ang): mixes columns 0, 2."""
    c, s = torch.cos(ang), torch.sin(ang)
    return R9(R.r00 * c - R.r02 * s, R.r01, R.r00 * s + R.r02 * c,
              R.r10 * c - R.r12 * s, R.r11, R.r10 * s + R.r12 * c,
              R.r20 * c - R.r22 * s, R.r21, R.r20 * s + R.r22 * c)


def mul_rz(R: R9, ang):
    """R @ Rz(ang): mixes columns 0, 1."""
    c, s = torch.cos(ang), torch.sin(ang)
    return R9(R.r00 * c + R.r01 * s, -R.r00 * s + R.r01 * c, R.r02,
              R.r10 * c + R.r11 * s, -R.r10 * s + R.r11 * c, R.r12,
              R.r20 * c + R.r21 * s, -R.r20 * s + R.r21 * c, R.r22)


def cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def stack3(v, dim=-1):
    return torch.stack(torch.broadcast_tensors(*v), dim=dim)


class _LegChain(NamedTuple):
    hip_Xp: np.ndarray     # (4,3) hip joint origin in base frame
    thigh_Xp: np.ndarray   # (4,3)
    calf_Xp: np.ndarray    # (4,3)
    foot_p: np.ndarray     # (4,3) foot frame offset in calf frame
    qidx: np.ndarray       # (12,) generalized-coordinate indices, leg-major


class _ArmChain(NamedTuple):
    XR: np.ndarray         # (6,3,3) joint origin rotations
    Xp: np.ndarray         # (6,3) joint origins
    qidx: np.ndarray       # (6,)
    ee_p: np.ndarray       # (3,) EE frame offset in the last body
    ee_R: np.ndarray       # (3,3)


_CACHE = {}


def _axis_is(a, key):
    return np.allclose(np.asarray(a), key)


def leg_chain(model: RobotModel) -> _LegChain:
    """Static leg-chain data; asserts the structure the chain relies on."""
    key = (id(model), "legs")
    if key not in _CACHE:
        hip_Xp = np.zeros((4, 3)); thigh_Xp = np.zeros((4, 3))
        calf_Xp = np.zeros((4, 3)); foot_p = np.zeros((4, 3))
        qidx = np.zeros((4, 3), dtype=np.int64)
        for f, fname in enumerate(CONTACT_FRAMES):
            bodies = [NUM_BASE + j for j in CONTACT_LEG_JOINTS[f]]
            assert int(model.parent[bodies[0]]) == NUM_BASE - 1
            assert int(model.parent[bodies[1]]) == bodies[0]
            assert int(model.parent[bodies[2]]) == bodies[1]
            for b in bodies:
                assert model.joint_type[b] == REVOLUTE
                assert np.allclose(model.X_tree_R[b], np.eye(3))
            assert _axis_is(model.axis[bodies[0]], (1, 0, 0))
            assert _axis_is(model.axis[bodies[1]], (0, 1, 0))
            assert _axis_is(model.axis[bodies[2]], (0, 1, 0))
            hip_Xp[f] = model.X_tree_p[bodies[0]]
            thigh_Xp[f] = model.X_tree_p[bodies[1]]
            calf_Xp[f] = model.X_tree_p[bodies[2]]
            fr = model.frame(fname)
            assert fr.body == bodies[2] and np.allclose(fr.R, np.eye(3))
            foot_p[f] = fr.p
            qidx[f] = bodies
        _CACHE[key] = (model, _LegChain(hip_Xp, thigh_Xp, calf_Xp, foot_p,
                                        qidx.reshape(-1)))
    return _CACHE[key][1]


def arm_chain(model: RobotModel) -> _ArmChain:
    """Static arm-chain data; asserts the structure the chain relies on."""
    key = (id(model), "arm")
    if key not in _CACHE:
        first = NUM_BASE + NUM_LEG_JOINTS
        bodies = list(range(first, first + 6))
        assert int(model.parent[first]) == NUM_BASE - 1
        for b in bodies[1:]:
            assert int(model.parent[b]) == b - 1
        for b in bodies:
            assert model.joint_type[b] == REVOLUTE
            assert _axis_is(model.axis[b], (0, 0, 1))
        fr = model.frame(EE_FRAME)
        assert fr.body == bodies[-1]
        _CACHE[key] = (model, _ArmChain(
            np.asarray(model.X_tree_R[bodies]), np.asarray(model.X_tree_p[bodies]),
            np.asarray(bodies, dtype=np.int64), np.asarray(fr.p),
            np.asarray(fr.R)))
    return _CACHE[key][1]


def foot_kinematics(model: RobotModel, q):
    """(p_feet (4,3), Jb (4,3,6), Jl (4,3,3)): foot positions plus linear
    Jacobian blocks (base columns, own-leg columns), lane-parallel over
    the 4 legs."""
    st = leg_chain(model)
    Rb = from_euler_zyx(q[3:6])
    pb = (q[0], q[1], q[2])
    q_legs = q[const(st.qidx, q, torch.int64)].reshape(4, 3)
    q0, q1, q2 = q_legs[:, 0], q_legs[:, 1], q_legs[:, 2]

    p_hip = add(pb, rotv_const(Rb, st.hip_Xp))
    R1 = mul_rx(Rb, q0)
    p_thigh = add(p_hip, rotv_const(R1, st.thigh_Xp))
    R2 = mul_ry(R1, q1)
    p_calf = add(p_thigh, rotv_const(R2, st.calf_Xp))
    R3 = mul_ry(R1, q1 + q2)                            # Ry(a)Ry(b)=Ry(a+b)
    p_foot = add(p_calf, rotv_const(R3, st.foot_p))

    # joint axes in world: HAA = col x of Rb; HFE/KFE = col y of R1
    a0 = Rb.col(0)
    a1 = (R1.r01, R1.r11, R1.r21)
    jl0 = cross(a0, sub(p_foot, p_hip))
    jl1 = cross(a1, sub(p_foot, p_thigh))
    jl2 = cross(a1, sub(p_foot, p_calf))
    Jl = torch.stack([stack3(jl0), stack3(jl1), stack3(jl2)], dim=-1)

    # base columns: prismatic x,y,z identity; revolute z, y, x at the base
    # origin with world axes z, Rz y, Rz Ry x
    cz, sz = torch.cos(q[3]), torch.sin(q[3])
    cy, sy = torch.cos(q[4]), torch.sin(q[4])
    az = (0.0, 0.0, 1.0)
    ay = (-sz, cz, 0.0)
    ax_ = (cz * cy, sz * cy, -sy)
    r = sub(p_foot, pb)
    rot_cols = torch.stack([stack3(cross(az, r)), stack3(cross(ay, r)),
                            stack3(cross(ax_, r))], dim=-1)    # (4,3,3)
    eye = torch.eye(3, dtype=q.dtype, device=q.device).expand(4, 3, 3)
    Jb = torch.cat([eye, rot_cols], dim=-1)                    # (4,3,6)
    return stack3(p_foot), Jb, Jl


def ee_pose(model: RobotModel, q):
    """(p_ee (3,), R_ee (3,3)) via the base->arm chain (all-z axes)."""
    st = arm_chain(model)
    R = from_euler_zyx(q[3:6])
    p = (q[0], q[1], q[2])
    qa = q[const(st.qidx, q, torch.int64)]
    eye = np.eye(3)
    for d in range(6):
        if not np.allclose(st.Xp[d], 0.0):
            p = add(p, rotv_const(R, st.Xp[d]))
        if not np.allclose(st.XR[d], eye):
            R = mul_const(R, st.XR[d])
        R = mul_rz(R, qa[d])
    if not np.allclose(st.ee_p, 0.0):
        p = add(p, rotv_const(R, st.ee_p))
    if not np.allclose(st.ee_R, eye):
        R = mul_const(R, st.ee_R)
    return stack3(p), R.to_mat()


def contact_positions(model: RobotModel, q):
    """(4,3) foot positions via the specialized leg chains."""
    st = leg_chain(model)
    Rb = from_euler_zyx(q[3:6])
    pb = (q[0], q[1], q[2])
    q_legs = q[const(st.qidx, q, torch.int64)].reshape(4, 3)
    p_hip = add(pb, rotv_const(Rb, st.hip_Xp))
    R1 = mul_rx(Rb, q_legs[:, 0])
    p_thigh = add(p_hip, rotv_const(R1, st.thigh_Xp))
    R2 = mul_ry(R1, q_legs[:, 1])
    p_calf = add(p_thigh, rotv_const(R2, st.calf_Xp))
    R3 = mul_ry(R1, q_legs[:, 1] + q_legs[:, 2])
    return stack3(add(p_calf, rotv_const(R3, st.foot_p)))


def mul_transpose(A: R9, B: R9) -> R9:
    """A @ B^T on scalar-structured matrices."""
    Ar = ((A.r00, A.r01, A.r02), (A.r10, A.r11, A.r12),
          (A.r20, A.r21, A.r22))
    Br = ((B.r00, B.r01, B.r02), (B.r10, B.r11, B.r12),
          (B.r20, B.r21, B.r22))
    return R9(*[Ar[i][0] * Br[j][0] + Ar[i][1] * Br[j][1]
                + Ar[i][2] * Br[j][2] for i in range(3) for j in range(3)])


def solve3_scalar(M: R9, b, damp=0.0):
    """Cramer solve M x = b with M as 9 scalars, b a 3-tuple."""
    if damp:
        M = M._replace(r00=M.r00 + damp, r11=M.r11 + damp, r22=M.r22 + damp)
    m00, m01, m02 = M.r00, M.r01, M.r02
    m10, m11, m12 = M.r10, M.r11, M.r12
    m20, m21, m22 = M.r20, M.r21, M.r22
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = torch.reciprocal(det)     # 1.0 / det: see _const.scalar
    bx, by, bz = b
    x = (c00 * bx + (m02 * m21 - m01 * m22) * by
         + (m01 * m12 - m02 * m11) * bz) * inv_det
    y = (c01 * bx + (m00 * m22 - m02 * m20) * by
         + (m02 * m10 - m00 * m12) * bz) * inv_det
    z = (c02 * bx + (m01 * m20 - m00 * m21) * by
         + (m00 * m11 - m01 * m10) * bz) * inv_det
    return (x, y, z)


def base_velocity_from_momentum(info, x):
    """[pdot_base(3); zyx_rates(3)] from normalized momentum (SRBD
    Ab^{-1}), scalar-structured as in the JAX module."""
    zyx = x[9:12]
    R = from_euler_zyx(zyx)
    RIc = mul_const(R, np.asarray(info.I_com_base))
    I_w = mul_transpose(RIc, R)
    mass = scalar(info.mass, x)
    L = (x[3] * mass, x[4] * mass, x[5] * mass)
    omega = solve3_scalar(I_w, L)
    r_w = rotv_const(R, np.asarray(info.r_com_base))
    v_com = (x[0], x[1], x[2])
    p_base_dot = sub(v_com, cross(omega, r_w))
    # E(zyx) zyx_dot = omega with E columns (z, Rz y, Rz Ry x)
    ca, sa = torch.cos(zyx[0]), torch.sin(zyx[0])
    cb, sb = torch.cos(zyx[1]), torch.sin(zyx[1])
    ox, oy, oz = omega
    a2 = -sa * ox + ca * oy
    a3 = (ca * ox + sa * oy) / cb
    a1 = oz + sb * a3
    return torch.stack([p_base_dot[0], p_base_dot[1], p_base_dot[2],
                        a1, a2, a3])
