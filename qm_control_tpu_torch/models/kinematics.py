"""Forward kinematics and geometric Jacobians (port of
qm_control_tpu/models/kinematics.py).

LOCAL_WORLD_ALIGNED convention: Jacobian rows are [linear(3); angular(3)]
in world axes at the frame origin. Velocity coordinates are plain q-dot,
so dJ/dt = jvp(J, q, v) exactly (torch.func.jvp here).

Functions take the static RobotModel and a (24,) q; they are functional
(no in-place writes, no host reads), so torch.func.vmap/jacfwd/jvp apply.
The MPC uses the scalar-structured chains of models/chainfk.py; the
generic lane-parallel chains `leg_chain_fk`, `foot_kinematics` and
`ee_chain_pose`, and `fk_unrolled`, are the JAX module's as well.
"""
from functools import partial

import numpy as np
import torch

from ._const import const
from ._fwd import jvp
from .rotations import axis_angle_to_R
from .smallmat import mm3, mv3
from .spec import (CONTACT_FRAMES, CONTACT_LEG_JOINTS, EE_FRAME, NUM_BASE,
                   NUM_LEG_JOINTS, PRISMATIC, REVOLUTE, RobotModel)

_STATIC = {}
_EYE3 = np.eye(3)


def _static(model: RobotModel):
    """Index arrays of the pointer-doubling FK, built once per model."""
    key = id(model)
    if key not in _STATIC:
        n = model.n_bodies
        depth = np.zeros(n, dtype=np.int64)
        for i in range(n):
            p = int(model.parent[i])
            depth[i] = 1 if p < 0 else depth[p] + 1
        rounds = max(1, int(np.ceil(np.log2(max(int(depth.max()), 2)))))
        anc = np.asarray(model.parent, dtype=np.int64)
        steps = []
        for _ in range(rounds):
            valid = anc >= 0
            j = np.maximum(anc, 0)
            steps.append((j, valid.astype(np.float32)[:, None, None].copy(),
                          valid.astype(np.float32)[:, None].copy()))
            anc = np.where(valid, anc[j], -1)
        par = np.asarray(model.parent)
        has_par = (par >= 0)
        st = dict(
            steps=steps,
            jp=np.maximum(par, 0).astype(np.int64),
            has_par3=has_par.astype(np.float32)[:, None, None].copy(),
            has_par2=has_par.astype(np.float32)[:, None].copy(),
            rev=(model.joint_type == 1).astype(np.float32),
            eye=np.eye(3, dtype=np.float32))
        _STATIC[key] = (model, st)
    return _STATIC[key][1]


def fk(model: RobotModel, q):
    """Forward kinematics for every body via pointer doubling.

    Returns dict with R (n,3,3) body orientations, p (n,3) body origins,
    a (n,3) world joint axes and o (n,3) world joint origins. As in the
    JAX module, ceil(log2(depth)) rounds of batched (n,3,3) products
    compose each body's chain (4 rounds for this robot)."""
    st = _static(model)
    XR = const(model.X_tree_R, q)                       # (n,3,3)
    Xp = const(model.X_tree_p, q)                       # (n,3)
    ax = const(model.axis, q)                           # (n,3)
    rev = const(st["rev"], q)                           # (n,)

    # local transforms: revolute  (XR @ Rot(ax, q), Xp)
    #                   prismatic (XR,              Xp + XR @ ax * q)
    Rj = axis_angle_to_R(ax, q * rev)
    L_R = mm3(XR, Rj)
    a_local = mv3(XR, ax)
    L_p = Xp + (1.0 - rev)[:, None] * a_local * q[:, None]

    R_w, p_w = L_R, L_p
    for j, vm3, vm2 in st["steps"]:
        jt = const(j, q, torch.int64)
        Rg, pg = R_w[jt], p_w[jt]
        R_new = mm3(Rg, R_w)
        p_new = pg + mv3(Rg, p_w)
        R_w = torch.where(const(vm3, q) > 0, R_new, R_w)
        p_w = torch.where(const(vm2, q) > 0, p_new, p_w)

    # joint frames: parent world pose composed with the constant offset
    jp = const(st["jp"], q, torch.int64)
    Rp = torch.where(const(st["has_par3"], q) > 0, R_w[jp], const(st["eye"], q))
    pp = torch.where(const(st["has_par2"], q) > 0, p_w[jp],
                     torch.zeros_like(p_w))
    o = pp + mv3(Rp, Xp)
    a = mv3(mm3(Rp, XR), ax)
    return dict(R=R_w, p=p_w, a=a, o=o)


def fk_unrolled(model: RobotModel, q):
    """Body-by-body FK down the tree (a flat unrolled graph); semantics
    identical to fk()."""
    Rs, ps, aw, ow = [], [], [], []
    for i in range(model.n_bodies):
        par = int(model.parent[i])
        if par < 0:
            Rp, pp = const(_EYE3, q), q.new_zeros(3)
        else:
            Rp, pp = Rs[par], ps[par]
        # constant joint-origin transforms: skip identity composes (common)
        XR, Xp = model.X_tree_R[i], model.X_tree_p[i]
        Ro = Rp if np.allclose(XR, _EYE3) else mm3(Rp, const(XR, q))
        po = pp if np.allclose(Xp, 0.0) else pp + mv3(Rp, const(Xp, q))
        ax = const(model.axis[i], q)
        a_world = mv3(Ro, ax)
        if model.joint_type[i] == PRISMATIC:
            Ri, pi = Ro, po + a_world * q[i]
        else:
            Ri, pi = mm3(Ro, axis_angle_to_R(ax, q[i])), po
        Rs.append(Ri)
        ps.append(pi)
        aw.append(a_world)
        ow.append(po)
    return dict(R=torch.stack(Rs), p=torch.stack(ps),
                a=torch.stack(aw), o=torch.stack(ow))


def frame_pose(model: RobotModel, cache, name):
    """(p, R) of a named frame in world."""
    fr = model.frame(name)
    Rb, pb = cache["R"][fr.body], cache["p"][fr.body]
    p = pb if np.allclose(fr.p, 0.0) else pb + mv3(Rb, const(fr.p, pb))
    R = Rb if np.allclose(fr.R, np.eye(3)) else mm3(Rb, const(fr.R, pb))
    return p, R


def point_jacobian(model: RobotModel, cache, point, body):
    """6 x nq geometric Jacobian of a world `point` on `body` (lin; ang)."""
    a, o = cache["a"], cache["o"]
    mask = const(model.ancestor, point)[:, body]
    rev = const(_static(model)["rev"], point)
    lin = rev[:, None] * torch.linalg.cross(a, point[None, :] - o) \
        + (1 - rev[:, None]) * a
    ang = rev[:, None] * a
    J = torch.cat([lin * mask[:, None], ang * mask[:, None]], dim=1)
    return J.T                                          # (6, n)


def frame_jacobian(model: RobotModel, q, name):
    """6 x nq Jacobian (LOCAL_WORLD_ALIGNED) of a named frame."""
    cache = fk(model, q)
    p, _ = frame_pose(model, cache, name)
    return point_jacobian(model, cache, p, model.frame(name).body)


def frame_jacobian_dot(model: RobotModel, q, v, name):
    """dJ/dt = dJ/dq * qdot (forward mode)."""
    _, jdot = jvp(partial(frame_jacobian, model, name=name), (q,), (v,))
    return jdot


def frame_velocity(model: RobotModel, q, v, name):
    """(6,) world-aligned [linear; angular] velocity of a frame."""
    return frame_jacobian(model, q, name) @ v


def all_body_jacobians(model: RobotModel, cache):
    """(n, 6, nq) Jacobians of every body-frame origin (vectorized)."""
    a, o, p = cache["a"], cache["o"], cache["p"]
    rev = const(_static(model)["rev"], p)[None, :, None]        # (1,n,1)
    mask = const(model.ancestor, p).T[:, :, None]               # (b,k,1)
    r = p[:, None, :] - o[None, :, :]                           # (b,k,3)
    a_b = a[None].expand(r.shape)
    lin = rev * torch.linalg.cross(a_b, r, dim=-1) + (1 - rev) * a[None]
    ang = rev * a_b
    J = torch.cat([lin * mask, ang * mask], dim=-1)             # (b,k,6)
    return J.transpose(1, 2)                                    # (b,6,k)


def frame_kinematics(model: RobotModel, q, cache=None):
    """One FK pass -> (Jc (12,nq), base_J (6,nq), ee_J (6,nq),
    feet_p (4,3), ee_p (3,), ee_R (3,3)) — every frame quantity the WBC
    needs (reference WbcBase.cpp:134-191)."""
    if cache is None:
        cache = fk(model, q)
    feet, jc_rows = [], []
    for f in CONTACT_FRAMES:
        p, _ = frame_pose(model, cache, f)
        feet.append(p)
        jc_rows.append(point_jacobian(model, cache, p,
                                      model.frame(f).body)[:3])
    base_p, _ = frame_pose(model, cache, "base")
    base_J = point_jacobian(model, cache, base_p, model.frame("base").body)
    ee_p, ee_R = frame_pose(model, cache, EE_FRAME)
    ee_J = point_jacobian(model, cache, ee_p, model.frame(EE_FRAME).body)
    return (torch.cat(jc_rows, dim=0), base_J, ee_J,
            torch.stack(feet), ee_p, ee_R)


class _LegStatic:
    """Per-leg chain constants in CONTACT_FRAMES order (LF, RF, LH, RH):
    the 4 leg chains are structurally identical (HAA, HFE, KFE revolute
    joints hanging off the base), so FK vectorizes over the leg axis —
    one lane-parallel chain of depth 3 instead of 12 scalar bodies."""

    def __init__(self, model: RobotModel):
        XR = np.zeros((4, 3, 3, 3))
        Xp = np.zeros((4, 3, 3))
        ax = np.zeros((4, 3, 3))
        qidx = np.zeros((4, 3), dtype=np.int64)
        foot_p = np.zeros((4, 3))
        for f, fname in enumerate(CONTACT_FRAMES):
            joints = CONTACT_LEG_JOINTS[f]
            for d, j in enumerate(joints):
                b = NUM_BASE + j
                assert model.joint_type[b] == REVOLUTE
                expect_parent = (NUM_BASE - 1 if d == 0
                                 else NUM_BASE + joints[d - 1])
                assert int(model.parent[b]) == expect_parent, (fname, d)
                XR[f, d] = model.X_tree_R[b]
                Xp[f, d] = model.X_tree_p[b]
                ax[f, d] = model.axis[b]
                qidx[f, d] = b
            fr = model.frame(fname)
            assert fr.body == NUM_BASE + joints[2]
            assert np.allclose(fr.R, np.eye(3))
            foot_p[f] = fr.p
        # per depth, contiguous (4, ...) slices: cached once per device
        self.XR = [XR[:, d].copy() for d in range(3)]
        self.Xp = [Xp[:, d].copy() for d in range(3)]
        self.ax = [ax[:, d].copy() for d in range(3)]
        self.qidx, self.foot_p = qidx.reshape(-1), foot_p


class _ArmStatic:
    """Arm chain constants: base -> 6 arm joints -> EE frame."""

    def __init__(self, model: RobotModel):
        first = NUM_BASE + NUM_LEG_JOINTS
        bodies = list(range(first, first + 6))
        assert int(model.parent[first]) == NUM_BASE - 1
        for b in bodies[1:]:
            assert int(model.parent[b]) == b - 1
        assert all(model.joint_type[b] == REVOLUTE for b in bodies)
        self.XR = [model.X_tree_R[b].copy() for b in bodies]
        self.Xp = [model.X_tree_p[b].copy() for b in bodies]
        self.ax = [model.axis[b].copy() for b in bodies]
        self.qidx = np.asarray(bodies, dtype=np.int64)
        fr = model.frame(EE_FRAME)
        assert fr.body == bodies[-1]
        self.ee_p, self.ee_R = fr.p, fr.R


_CHAIN_STATIC = {}


def _chain_static(cls, model: RobotModel):
    key = (cls, id(model))
    if key not in _CHAIN_STATIC:
        _CHAIN_STATIC[key] = (model, cls(model))
    return _CHAIN_STATIC[key][1]


def leg_chain_fk(model: RobotModel, q):
    """Vectorized FK of the 4 leg chains. Returns (p_feet (4,3), a_w
    (4,3,3) world joint axes [leg, depth, xyz], o_w (4,3,3) world joint
    origins, R_base, p_base)."""
    from .rotations import euler_zyx_to_R
    st = _chain_static(_LegStatic, model)
    Rb = euler_zyx_to_R(q[3:6])
    pb = q[0:3]
    qleg = q[const(st.qidx, q, torch.int64)].reshape(4, 3)
    R = Rb.expand(4, 3, 3)
    p = pb.expand(4, 3)
    a_ws, o_ws = [], []
    for d in range(3):
        axd = const(st.ax[d], q)                        # (4,3)
        Ro = mm3(R, const(st.XR[d], q))
        po = p + mv3(R, const(st.Xp[d], q))
        a_ws.append(mv3(Ro, axd))
        o_ws.append(po)
        R = mm3(Ro, axis_angle_to_R(axd, qleg[:, d]))
        p = po
    p_feet = p + mv3(R, const(st.foot_p, q))
    return (p_feet, torch.stack(a_ws, dim=1), torch.stack(o_ws, dim=1),
            Rb, pb)


def foot_kinematics(model: RobotModel, q):
    """(p_feet (4,3), Jb (4,3,6), Jl (4,3,3)) in one vectorized pass:
    foot positions plus each foot's linear Jacobian split into base
    columns and own-leg columns (the only nonzero blocks), in closed
    form a_k x (p - o_k): no autodiff, no full-tree FK."""
    p_feet, a_w, o_w, Rb, pb = leg_chain_fk(model, q)
    # own-leg columns (depth d): a_d x (p_foot - o_d)
    Jl = torch.stack([torch.linalg.cross(a_w[:, d], p_feet - o_w[:, d])
                      for d in range(3)], dim=-1)       # (4,3,3)
    # base columns: 3 prismatic world-aligned (identity), then revolute
    # z, y, x at the base origin with axes z, Rz y, Rz Ry x
    cz, sz = torch.cos(q[3]), torch.sin(q[3])
    cy, sy = torch.cos(q[4]), torch.sin(q[4])
    zero, one = torch.zeros_like(cz), torch.ones_like(cz)
    az = torch.stack([zero, zero, one])
    ay = torch.stack([-sz, cz, zero])
    ax_ = torch.stack([cz * cy, sz * cy, -sy])
    r = p_feet - pb                                     # (4,3)
    rot_cols = torch.stack([torch.linalg.cross(a.expand(4, 3), r)
                            for a in (az, ay, ax_)], dim=-1)   # (4,3,3)
    eye = const(_EYE3, q).expand(4, 3, 3)
    Jb = torch.cat([eye, rot_cols], dim=-1)             # (4,3,6)
    return p_feet, Jb, Jl


def ee_chain_pose(model: RobotModel, q):
    """(p_ee, R_ee) via the base -> arm chain only (a flat unrolled
    depth-6 chain; the feet do not affect the EE) (reference: OCS2
    PinocchioEndEffectorKinematicsCppAd, QMInterface.cpp:363-379)."""
    from .rotations import euler_zyx_to_R
    st = _chain_static(_ArmStatic, model)
    R = euler_zyx_to_R(q[3:6])
    p = q[0:3]
    qa = q[const(st.qidx, q, torch.int64)]
    for d in range(6):
        Ro = mm3(R, const(st.XR[d], q))
        p = p + mv3(R, const(st.Xp[d], q))
        R = mm3(Ro, axis_angle_to_R(const(st.ax[d], q), qa[d]))
    p_ee = p if np.allclose(st.ee_p, 0.0) else p + mv3(R, const(st.ee_p, q))
    R_ee = R if np.allclose(st.ee_R, np.eye(3)) else mm3(R, const(st.ee_R, q))
    return p_ee, R_ee


def contact_positions(model: RobotModel, q):
    """(4,3) world positions of the contact frames (LF, RF, LH, RH), via
    the scalar-structured leg chains (models/chainfk.py)."""
    from . import chainfk
    return chainfk.contact_positions(model, q)


def stacked_contact_jacobian(model: RobotModel, q):
    """(12, nq) stacked 3-DoF contact Jacobians (reference
    WbcBase.cpp:159-175)."""
    cache = fk(model, q)
    rows = []
    for f in CONTACT_FRAMES:
        p, _ = frame_pose(model, cache, f)
        rows.append(point_jacobian(model, cache, p, model.frame(f).body)[:3])
    return torch.cat(rows, dim=0)


def stacked_contact_jacobian_dot(model: RobotModel, q, v):
    _, jdot = jvp(partial(stacked_contact_jacobian, model), (q,), (v,))
    return jdot
