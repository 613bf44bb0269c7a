"""Target trajectories: the 37-dim MPC reference (port of
qm_control_tpu/ocp/reference.py).

Target states are R^37 = [centroidal state(30); EE pose(7)], the EE pose
[position(3); quaternion (x,y,z,w)] (the reference's TargetTrajectories,
QmTargetTrajectoriesPublisher_node.cpp:60-62). A TargetTrajectory is K
padded knots of (time, state); interpolation is linear on the 33 linear
dims and slerp on the quaternion (EndEffectorConstraint::
interpolateEndEffectorPose, reference :82-113). The interpolators take a
time tensor of any shape (one per MPC node) and run under torch.func.
"""
from typing import NamedTuple

import numpy as np
import torch

from ..models.rotations import quat_slerp

TARGET_DIM = 37
MAX_KNOTS = 8          # fixed padding; command conversions emit 2 knots


class TargetTrajectory(NamedTuple):
    """Padded (time, state) knot sequence: times non-decreasing over the
    first n knots; padding repeats the last knot at t = 1e9."""
    times: torch.Tensor     # (K,)
    states: torch.Tensor    # (K, 37)


def target_from_knots(times, states, device="cuda", dtype=torch.float32):
    """Host-side constructor with padding to MAX_KNOTS."""
    from .. import resolve_device
    dev = resolve_device(device)
    times = np.asarray(times, dtype=np.float64)
    states = np.atleast_2d(np.asarray(states, dtype=np.float64))
    k = len(times)
    if states.shape != (k, TARGET_DIM):
        raise ValueError(f"target states shape {states.shape} != "
                         f"({k}, {TARGET_DIM})")
    t = np.full(MAX_KNOTS, 1e9)
    t[:k] = times
    s = np.tile(states[-1], (MAX_KNOTS, 1))
    s[:k] = states
    return TargetTrajectory(torch.as_tensor(t, dtype=dtype, device=dev),
                            torch.as_tensor(s, dtype=dtype, device=dev))


def _segment(times, t):
    """(index, alpha) with value = alpha*knot[i] + (1-alpha)*knot[i+1]
    (OCS2 LinearInterpolation::timeSegment: alpha weighs the LEFT knot,
    clamped outside the range). index and alpha have t's shape."""
    t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
    # searchsorted(times, t, right=True) as a count of knots <= t: under
    # vmap the batched value tensor reaches searchsorted's kernel
    # permuted (non-contiguous) whatever its logical layout, and the
    # kernel then warns and copies on every call
    idx = (times <= t.reshape(-1, 1)).sum(-1) - 1
    idx = torch.clamp(idx, 0, times.shape[0] - 2)
    t0 = times.index_select(0, idx).reshape(t.shape)
    t1 = times.index_select(0, idx + 1).reshape(t.shape)
    denom = torch.where(t1 - t0 < 1e-9, torch.ones_like(t0), t1 - t0)
    alpha = torch.clamp(1.0 - (t - t0) / denom, 0.0, 1.0)
    return idx.reshape(t.shape), alpha


def interpolate_state(target: TargetTrajectory, t):
    """(..., 37) interpolated target (quaternion tail slerped)."""
    idx, alpha = _segment(target.times, t)
    flat = idx.reshape(-1)
    shape = idx.shape + (TARGET_DIM,)
    lhs = target.states.index_select(0, flat).reshape(shape)
    rhs = target.states.index_select(0, flat + 1).reshape(shape)
    a = alpha[..., None]
    lin = a * lhs + (1.0 - a) * rhs
    q = _slerp_xyzw(lhs[..., 33:37], rhs[..., 33:37], 1.0 - alpha)
    return torch.cat([lin[..., :33], q], dim=-1)


def _slerp_xyzw(q0_xyzw, q1_xyzw, t):
    """Slerp on (x,y,z,w)-ordered quaternions (target-state convention)."""
    def to_wxyz(q):
        return torch.cat([q[..., 3:4], q[..., :3]], dim=-1)
    q = quat_slerp(to_wxyz(q0_xyzw), to_wxyz(q1_xyzw), t)
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def interpolate_ee_pose(target: TargetTrajectory, t):
    """EE (position (...,3), quaternion wxyz (...,4)) at time(s) t."""
    x = interpolate_state(target, t)
    q_xyzw = x[..., 33:37]
    return x[..., 30:33], torch.cat([q_xyzw[..., 3:4], q_xyzw[..., :3]],
                                    dim=-1)
