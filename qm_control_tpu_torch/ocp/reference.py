"""Target trajectories: the 37-dim MPC reference (port of
qm_control_tpu/ocp/reference.py).

Target states are R^37 = [centroidal state(30); EE pose(7)], the EE pose
[position(3); quaternion (x,y,z,w)] (the reference's TargetTrajectories,
QmTargetTrajectoriesPublisher_node.cpp:60-62). A TargetTrajectory is K
padded knots of (time, state); interpolation is linear on the 33 linear
dims and slerp on the quaternion (EndEffectorConstraint::
interpolateEndEffectorPose, reference :82-113). The interpolators take a
time tensor of any shape (one per MPC node) and run under torch.func.

The command conversions at the end (the reference's
QmTargetTrajectoriesPublisher_node.cpp:25-208) run on the host: numpy
observations in, a TargetTrajectory on `device` out.
"""
from typing import NamedTuple

import numpy as np
import torch

from ..config import ReferenceConfig
from ..models.rotations import (euler_zyx_to_R, quat_distance, quat_slerp,
                                quat_to_R)

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


# ---------------------------------------------------------------------------
# Command conversions (reference QmTargetTrajectoriesPublisher_node.cpp).
# The knot arithmetic is float64 numpy; the rotations are float32 on the
# CPU, as the JAX package computes them, so the knots agree to f32
# roundoff. The (0.52, 0.09) base-from-EE offset is the reference's
# hard-coded arm-mount offset (_node.cpp:152-153, :185-186).
# ---------------------------------------------------------------------------

EE_BASE_OFFSET = np.array([0.52, 0.09])
TIME_TO_TARGET = 1.0


def _f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           dtype=torch.float32)


def estimate_time_to_target(delta, cfg: ReferenceConfig):
    """Arrival-time heuristic from displacement/rotation speed limits
    (reference _node.cpp:25-41)."""
    disp = float(np.linalg.norm(delta[:3]))
    rot = float(np.linalg.norm(delta[3:6]))
    return max(disp / cfg.target_displacement_velocity,
               rot / cfg.target_rotation_velocity)


def _two_knot_target(t0, t1, base0, base1, ee0, ee1, cfg, momentum0=None,
                     momentum1=None, device="cuda"):
    djs = np.asarray(cfg.default_joint_state)
    z6 = np.zeros(6)
    m0 = z6 if momentum0 is None else momentum0
    m1 = z6 if momentum1 is None else momentum1
    s0 = np.concatenate([m0, base0, djs, ee0])
    s1 = np.concatenate([m1, base1, djs, ee1])
    return target_from_knots([t0, t1], [s0, s1], device=device)


def _level_base(base, cfg: ReferenceConfig):
    """The base pose at the commanded height with roll and pitch zeroed."""
    out = np.array(base, dtype=np.float64)
    out[2] = cfg.com_height
    out[4] = 0.0
    out[5] = 0.0
    return out


def goal_pose_to_target(ee_pos, ee_quat_wxyz, obs_time, obs_state, ee_state,
                        cfg: ReferenceConfig, device="cuda"):
    """RViz goal-pose conversion (reference EEgoalPoseToTargetTrajectories).
    ee_state: the current EE pose [pos(3), quat xyzw(4)]; obs_state (30,)."""
    base_cur = np.array(obs_state[6:12], dtype=np.float64)
    q_xyzw = np.array([ee_quat_wxyz[1], ee_quat_wxyz[2], ee_quat_wxyz[3],
                       ee_quat_wxyz[0]])
    ee_target = np.concatenate([np.asarray(ee_pos, dtype=np.float64), q_xyzw])
    base_target = _level_base(base_cur, cfg)
    base_target[0] = ee_pos[0] - EE_BASE_OFFSET[0]
    base_target[1] = ee_pos[1] - EE_BASE_OFFSET[1]
    q_cur = [ee_state[6], ee_state[3], ee_state[4], ee_state[5]]
    delta = np.concatenate([
        ee_target[:3] - np.asarray(ee_state[:3]),
        quat_distance(_f32(q_cur), _f32(ee_quat_wxyz)).numpy()])
    t1 = obs_time + estimate_time_to_target(delta, cfg)
    base0 = _level_base(base_cur, cfg)
    return _two_knot_target(obs_time, t1, base0, base_target,
                            np.asarray(ee_state, dtype=np.float64),
                            ee_target, cfg, device=device)


def cmd_vel_to_target(cmd_vel, last_ee_target, obs_time, obs_state, ee_state,
                      cfg: ReferenceConfig, device="cuda"):
    """Base velocity command (reference cmdVelToTargetTrajectories).
    cmd_vel = [vx, vy, vz, yaw_rate] in the base frame; the EE target is
    held at last_ee_target (re-latched to the measured EE if it is more
    than 10 cm away). Returns (TargetTrajectory, new_last_ee_target)."""
    base_cur = np.array(obs_state[6:12], dtype=np.float64)
    R = euler_zyx_to_R(_f32(base_cur[3:6])).numpy()
    v_world = R @ np.asarray(cmd_vel[:3], dtype=np.float64)
    base_target = np.array([
        base_cur[0] + v_world[0] * TIME_TO_TARGET,
        base_cur[1] + v_world[1] * TIME_TO_TARGET,
        cfg.com_height,
        base_cur[3] + cmd_vel[3] * TIME_TO_TARGET,
        0.0, 0.0])
    last_ee_target = np.array(last_ee_target, dtype=np.float64)
    if np.linalg.norm(last_ee_target[:3] - np.asarray(ee_state[:3])) > 0.1:
        last_ee_target[:3] = ee_state[:3]
    base0 = _level_base(base_cur, cfg)
    momentum = np.concatenate([v_world, np.zeros(3)])
    traj = _two_knot_target(obs_time, obs_time + TIME_TO_TARGET,
                            base0, base_target, last_ee_target,
                            last_ee_target, cfg, momentum0=momentum,
                            momentum1=momentum, device=device)
    return traj, last_ee_target


def ee_cmd_vel_to_target(cmd_vel, last_ee_target, obs_time, obs_state,
                         ee_state, cfg: ReferenceConfig, device="cuda"):
    """EE velocity command (reference EeCmdVelToTargetTrajectories).
    cmd_vel[:3] is in the EE tool frame relative to the nominal tool
    orientation quat_init = (w=-0.5, x=0.5, y=-0.5, z=0.5); the base
    target follows the EE with the fixed mount offset. Returns
    (TargetTrajectory, new_last_ee_target)."""
    base_cur = np.array(obs_state[6:12], dtype=np.float64)
    q_cur = _f32([ee_state[6], ee_state[3], ee_state[4], ee_state[5]])
    q_init = _f32([-0.5, 0.5, -0.5, 0.5])
    v_world = (quat_to_R(q_cur) @ quat_to_R(q_init).T
               @ _f32(cmd_vel[:3])).numpy()
    ee_target = np.array(last_ee_target, dtype=np.float64)
    ee_target[0] = ee_state[0] + v_world[0] * TIME_TO_TARGET
    ee_target[1] = ee_state[1] + v_world[1] * TIME_TO_TARGET
    base_target = _level_base(base_cur, cfg)
    base_target[0] = ee_target[0] - EE_BASE_OFFSET[0]
    base_target[1] = ee_target[1] - EE_BASE_OFFSET[1]
    base0 = _level_base(base_cur, cfg)
    traj = _two_knot_target(obs_time, obs_time + TIME_TO_TARGET,
                            base0, base_target,
                            np.asarray(ee_state, dtype=np.float64),
                            ee_target, cfg, device=device)
    return traj, ee_target
