"""Gait library and gait schedule management (port of
qm_control_tpu/gaits/library.py).

The 12 named gaits are the reference's gait.info mode-sequence templates
(qm_controllers/config/gait.info:1-255). GaitSchedule is the host-side
rolling schedule (OCS2 GaitSchedule + GaitReceiver): it tiles the active
template over the MPC horizon and emits the padded ModeSchedule tensors on
the requested device.
"""
from dataclasses import dataclass, field
from typing import List

from .gait import (MAX_EVENTS, STANCE, ModeSchedule, mode_name_to_number,
                   mode_schedule_from_lists)


@dataclass(frozen=True)
class ModeSequenceTemplate:
    """One gait cycle: len(switching_times) == len(mode_sequence) + 1."""
    mode_sequence: tuple      # mode numbers
    switching_times: tuple    # relative times, first is 0

    @property
    def duration(self):
        return self.switching_times[-1] - self.switching_times[0]

    @staticmethod
    def from_names(names, times):
        return ModeSequenceTemplate(
            tuple(mode_name_to_number(n) for n in names), tuple(times))


_G = ModeSequenceTemplate.from_names
GAIT_LIBRARY = {
    "stance": _G(["STANCE"], [0.0, 0.5]),
    "trot": _G(["LF_RH", "RF_LH"], [0.0, 0.35, 0.70]),
    "standing_trot": _G(["LF_RH", "STANCE", "RF_LH", "STANCE"],
                        [0.0, 0.4, 0.5, 0.9, 1.0]),
    "flying_trot": _G(["LF_RH", "FLY", "RF_LH", "FLY"],
                      [0.0, 0.25, 0.30, 0.55, 0.60]),
    "pace": _G(["LF_LH", "FLY", "RF_RH", "FLY"],
               [0.0, 0.28, 0.30, 0.58, 0.60]),
    "standing_pace": _G(["LF_LH", "STANCE", "RF_RH", "STANCE"],
                        [0.0, 0.30, 0.35, 0.65, 0.70]),
    "dynamic_walk": _G(["LF_RF_RH", "RF_RH", "RF_LH_RH",
                        "LF_RF_LH", "LF_LH", "LF_LH_RH"],
                       [0.0, 0.2, 0.3, 0.5, 0.7, 0.8, 1.0]),
    "static_walk": _G(["LF_RF_RH", "RF_LH_RH", "LF_RF_LH", "LF_LH_RH"],
                      [0.0, 0.3, 0.6, 0.9, 1.2]),
    "amble": _G(["RF_LH", "LF_LH", "LF_RH", "RF_RH"],
                [0.0, 0.15, 0.40, 0.55, 0.80]),
    "lindyhop": _G(["LF_RH", "STANCE", "RF_LH", "STANCE", "LF_LH", "RF_RH",
                    "LF_LH", "STANCE", "RF_RH", "LF_LH", "RF_RH", "STANCE"],
                   [0.0, 0.35, 0.45, 0.80, 0.90, 1.125, 1.35, 1.70, 1.80,
                    2.025, 2.25, 2.60, 2.70]),
    "skipping": _G(["LF_RH", "FLY", "LF_RH", "FLY",
                    "RF_LH", "FLY", "RF_LH", "FLY"],
                   [0.0, 0.27, 0.30, 0.57, 0.60, 0.87, 0.90, 1.17, 1.20]),
    "pawup": _G(["RF_LH_RH"], [0.0, 2.0]),
}


@dataclass
class GaitSchedule:
    """Rolling mode schedule with template insertion (host side).

    OCS2 GaitSchedule semantics: an explicit schedule prefix plus a
    periodic template extended on demand; `insert_template` schedules a
    gait switch at a future time (reference GaitJoyPublisher.cpp:18-60).
    Invariants: len(modes) == len(event_times) + 1; modes[i] is active on
    [event_times[i-1], event_times[i]); `cycle_anchor` is where the next
    template cycle is tiled.
    """
    template: ModeSequenceTemplate = field(
        default_factory=lambda: GAIT_LIBRARY["stance"])
    event_times: List[float] = field(default_factory=list)
    modes: List[int] = field(default_factory=lambda: [STANCE])
    cycle_anchor: float = 0.0
    phase_transition_stance_time: float = 0.1   # task.info:11

    def _append(self, t_start: float, mode: int):
        self.event_times.append(float(t_start))
        self.modes.append(int(mode))

    def insert_template(self, template: ModeSequenceTemplate,
                        start_time: float):
        """Truncate the schedule at start_time and switch to the new gait,
        inserting a short transition stance (phaseTransitionStanceTime)."""
        self._trim_after(start_time)
        t = start_time
        if self.phase_transition_stance_time > 0:
            self._append(t, STANCE)
            t += self.phase_transition_stance_time
        self.template = template
        self.cycle_anchor = t

    def _trim_after(self, t):
        keep = [i for i, et in enumerate(self.event_times) if et < t]
        self.event_times = [self.event_times[i] for i in keep]
        self.modes = self.modes[:len(keep) + 1]
        self.cycle_anchor = max(t, self.event_times[-1]
                                if self.event_times else t)

    def _tile_until(self, t_final):
        tmpl = self.template
        rel = tmpl.switching_times
        while self.cycle_anchor < t_final:
            t0 = self.cycle_anchor
            for k, m in enumerate(tmpl.mode_sequence):
                self._append(t0 + rel[k] - rel[0], m)
            self.cycle_anchor = t0 + tmpl.duration

    def _prune_before(self, t):
        """Drop leading (event, mode) pairs strictly older than t."""
        while len(self.event_times) > 1 and self.event_times[1] < t:
            self.event_times.pop(0)
            self.modes.pop(0)

    def mode_schedule(self, lo: float, hi: float,
                      device="cuda") -> ModeSchedule:
        """Padded tensors on `device` covering [lo, hi] (extends by
        tiling). A window that needs more than MAX_EVENTS (47) events
        raises instead of truncating (a truncated schedule freezes the
        mode at its 48th entry): query a receding window."""
        self._tile_until(hi + self.template.duration)
        self._prune_before(lo - 1.0)
        if len(self.event_times) > MAX_EVENTS:
            needed_hi = self.event_times[MAX_EVENTS - 1]
            raise ValueError(
                f"mode schedule [{lo:.2f}, {hi:.2f}] needs "
                f"{len(self.event_times)} events > MAX_EVENTS="
                f"{MAX_EVENTS} (coverage ends at t={needed_hi:.2f}); "
                "query a receding window instead of one long schedule")
        return mode_schedule_from_lists(self.event_times, self.modes,
                                        device=device)
