"""Forward kinematics and geometric Jacobians (port of
qm_control_tpu/models/kinematics.py).

LOCAL_WORLD_ALIGNED convention: Jacobian rows are [linear(3); angular(3)]
in world axes at the frame origin. Velocity coordinates are plain q-dot,
so dJ/dt = jvp(J, q, v) exactly (torch.func.jvp here).

Functions take the static RobotModel and a (24,) q; they are functional
(no in-place writes, no host reads), so torch.func.vmap/jacfwd/jvp apply.
The MPC uses the scalar-structured chains of models/chainfk.py; the JAX
module's generic `leg_chain_fk`, `foot_kinematics` and `ee_chain_pose`
are not ported.
"""
from functools import partial

import numpy as np
import torch
from torch.func import jvp

from ._const import const
from .rotations import axis_angle_to_R
from .smallmat import mm3, mv3
from .spec import CONTACT_FRAMES, EE_FRAME, RobotModel

_STATIC = {}


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
