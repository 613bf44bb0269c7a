"""Swing-foot z references (port of qm_control_tpu/gaits/swing.py;
reference SwingTrajectoryPlanner, task.info:23-30).

Per foot and query time, the enclosing swing phase [t_liftoff,
t_touchdown] comes from the ModeSchedule by masked reductions (no
data-dependent branches), and two cubic Hermite segments run liftoff ->
apex -> touchdown with the liftOff/touchDown velocity conditions and the
amplitude scale s = min(1, swingDuration / swingTimeScale).
"""
from typing import NamedTuple

import torch

from .gait import ModeSchedule, foot_contact_sequence


class SwingConfig(NamedTuple):
    lift_off_velocity: float = 0.05     # task.info:25
    touch_down_velocity: float = -0.1   # task.info:26
    swing_height: float = 0.15          # task.info:27
    touchdown_after_horizon: float = 0.2  # task.info:28
    swing_time_scale: float = 0.15      # task.info:29


def _cubic_hermite(t, t0, t1, z0, z1, v0, v1):
    """Cubic Hermite value and derivative at t on [t0, t1]."""
    dt = torch.clamp(t1 - t0, min=1e-6)
    s = (t - t0) / dt
    h00 = 2 * s**3 - 3 * s**2 + 1
    h10 = s**3 - 2 * s**2 + s
    h01 = -2 * s**3 + 3 * s**2
    h11 = s**3 - s**2
    z = h00 * z0 + h10 * dt * v0 + h01 * z1 + h11 * dt * v1
    dh00 = 6 * s**2 - 6 * s
    dh10 = 3 * s**2 - 4 * s + 1
    dh01 = -6 * s**2 + 6 * s
    dh11 = 3 * s**2 - 2 * s
    zd = (dh00 * z0 / dt + dh10 * v0 + dh01 * z1 / dt + dh11 * v1)
    return z, zd


def swing_phase_bounds(ms: ModeSchedule, foot: int, t, horizon_end):
    """(t_liftoff, t_touchdown) of the swing phase containing t (t of any
    shape). Without a preceding liftoff event, t - 0.3; with the touchdown
    beyond the schedule, horizon_end + 0.2 (touchdownAfterHorizon)."""
    c = foot_contact_sequence(ms, foot)              # (K+1,)
    et = ms.event_times                              # (K,)
    lift = c[:-1] & ~c[1:]                           # boundary b at et[b]
    touch = ~c[:-1] & c[1:]
    tt = t[..., None]
    big = torch.full_like(et, 1e9)
    t_lo = torch.where(lift & (et <= tt), et, -big).amax(-1)
    t_td = torch.where(touch & (et > tt), et, big).amin(-1)
    t_lo = torch.where(t_lo < -1e8, t - 0.3, t_lo)
    t_td = torch.where(t_td > 1e8, horizon_end + 0.2, t_td)
    return t_lo, t_td


def swing_z_reference(ms: ModeSchedule, foot: int, t, horizon_end,
                      cfg: SwingConfig = SwingConfig(), terrain_height=0.0):
    """(z_ref, zdot_ref) for one foot at time(s) t; valid while the foot
    swings (callers mask with the contact flag)."""
    t = torch.as_tensor(t, dtype=ms.event_times.dtype,
                        device=ms.event_times.device)
    t0, t1 = swing_phase_bounds(ms, foot, t, horizon_end)
    duration = t1 - t0
    scale = torch.clamp(duration / cfg.swing_time_scale, max=1.0)
    tm = 0.5 * (t0 + t1)
    z0 = terrain_height
    z1 = terrain_height
    zmax = terrain_height + cfg.swing_height * scale
    v0 = cfg.lift_off_velocity * scale
    v1 = cfg.touch_down_velocity * scale
    vm = (z1 - z0) / torch.clamp(duration, min=1e-6)
    za, zda = _cubic_hermite(t, t0, tm, z0, zmax, v0, vm)
    zb, zdb = _cubic_hermite(t, tm, t1, zmax, z1, vm, v1)
    first = t <= tm
    return torch.where(first, za, zb), torch.where(first, zda, zdb)
