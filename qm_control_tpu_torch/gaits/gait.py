"""Gait mode numbering and mode schedules (port of
qm_control_tpu/gaits/gait.py).

Mode numbering matches OCS2 legged-robot: contact flags (LF, RF, LH, RH)
pack as bits, mode = 8*LF + 4*RF + 2*LH + 1*RH (STANCE=15, FLY=0).
A ModeSchedule is padded tensors of event times and mode ids, queryable
at any t on the device.
"""
from typing import NamedTuple

import numpy as np
import torch

MAX_EVENTS = 47   # fixed padding (schedules are repeated gait cycles)

MODE_NAMES = {
    0: "FLY", 1: "RH", 2: "LH", 3: "LH_RH", 4: "RF", 5: "RF_RH",
    6: "RF_LH", 7: "RF_LH_RH", 8: "LF", 9: "LF_RH", 10: "LF_LH",
    11: "LF_LH_RH", 12: "LF_RF", 13: "LF_RF_RH", 14: "LF_RF_LH", 15: "STANCE",
}
_NAME_TO_MODE = {v: k for k, v in MODE_NAMES.items()}
STANCE, FLY = 15, 0


def mode_name_to_number(name: str) -> int:
    return _NAME_TO_MODE[name.upper()]


def contact_flags_from_mode(mode):
    """(..., 4) bool flags (LF, RF, LH, RH) from mode number(s)."""
    mode = torch.as_tensor(mode)
    return torch.stack([(mode >> 3) & 1, (mode >> 2) & 1,
                        (mode >> 1) & 1, mode & 1], dim=-1).to(torch.bool)


def mode_from_contact_flags(flags):
    flags = torch.as_tensor(flags).to(torch.int32)
    return (8 * flags[..., 0] + 4 * flags[..., 1] + 2 * flags[..., 2]
            + flags[..., 3])


class ModeSchedule(NamedTuple):
    """Padded mode schedule. modes[i] is active on
    [event_times[i-1], event_times[i]); padding repeats the last mode."""
    event_times: torch.Tensor   # (MAX_EVENTS,)
    modes: torch.Tensor         # (MAX_EVENTS + 1,) int32


def mode_schedule_from_lists(event_times, modes, device="cuda",
                             dtype=torch.float32):
    """Build a padded ModeSchedule from python lists (host side)."""
    from .. import resolve_device
    dev = resolve_device(device)
    k = len(event_times)
    if len(modes) != k + 1 or k > MAX_EVENTS:
        raise ValueError(f"{k} events need {k + 1} modes and k <= "
                         f"{MAX_EVENTS}; got {len(modes)} modes")
    et = np.full(MAX_EVENTS, 1e9, dtype=np.float64)
    et[:k] = event_times
    md = np.full(MAX_EVENTS + 1, modes[-1], dtype=np.int32)
    md[:k + 1] = modes
    return ModeSchedule(torch.as_tensor(et, dtype=dtype, device=dev),
                        torch.as_tensor(md, device=dev))


def mode_at_time(ms: ModeSchedule, t):
    """Active mode at time(s) t, any shape (device, branch-free)."""
    t = torch.as_tensor(t, dtype=ms.event_times.dtype,
                        device=ms.event_times.device)
    idx = torch.searchsorted(ms.event_times, t.reshape(-1), right=True)
    return ms.modes.index_select(0, idx).reshape(t.shape)


def contact_flags_at_time(ms: ModeSchedule, t):
    return contact_flags_from_mode(mode_at_time(ms, t))


def foot_contact_sequence(ms: ModeSchedule, foot: int):
    """(MAX_EVENTS+1,) bool contact flag of one foot per schedule phase."""
    shift = (3, 2, 1, 0)[foot]
    return ((ms.modes >> shift) & 1).to(torch.bool)
