"""Command / teleop layer: gait switching and target command conversion
(port of qm_control_tpu/runtime/commands.py).

It replaces the reference's command processes (SURVEY.md §1 L7):
  - the QmTargetTrajectoriesPublisher node (goal pose / cmd_vel /
    ee_cmd_vel -> TargetTrajectories; the conversions live in
    ocp/reference.py);
  - GaitJoyPublisher (gamepad button combos -> mode schedule,
    qm_controllers/src/GaitJoyPublisher.cpp:18-60; LB+A = trot,
    LB+B = stance) and the keyboard gait selector of ocs2_legged_robot_ros.
ROS topics become method calls and an in-process queue. The commanders
run on the host and hand out tensors on their `device`.
"""
import queue
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import resolve_device
from ..config import ReferenceConfig
from ..gaits.library import GAIT_LIBRARY, GaitSchedule
from ..ocp.reference import (TargetTrajectory, cmd_vel_to_target,
                             ee_cmd_vel_to_target, goal_pose_to_target)

# reference GaitJoyPublisher.cpp:41-49: button combos -> named gaits
JOY_GAIT_BINDINGS = {
    ("LB", "A"): "trot",
    ("LB", "B"): "stance",
    ("LB", "X"): "standing_trot",
    ("LB", "Y"): "flying_trot",
}


@dataclass
class GaitCommander:
    """Gait switching front end over a GaitSchedule (the GaitJoyPublisher
    and keyboard gait node); mode schedules come out on `device`."""
    schedule: GaitSchedule = field(default_factory=GaitSchedule)
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def switch(self, gait_name: str, at_time: float):
        """Keyboard-style: switch to a named gait from the library."""
        if gait_name not in GAIT_LIBRARY:
            raise KeyError(f"unknown gait '{gait_name}'; have "
                           f"{sorted(GAIT_LIBRARY)}")
        self.schedule.insert_template(GAIT_LIBRARY[gait_name], at_time)

    def joy(self, buttons, at_time: float) -> Optional[str]:
        """Gamepad-style: button combo -> gait switch. Returns the gait
        name if a binding fired."""
        pressed = tuple(sorted(b for b, on in buttons.items() if on))
        for combo, gait in JOY_GAIT_BINDINGS.items():
            if all(b in pressed for b in combo):
                self.switch(gait, at_time)
                return gait
        return None

    def mode_schedule(self, lo: float, hi: float):
        return self.schedule.mode_schedule(lo, hi, device=self.device)


@dataclass
class TargetCommander:
    """Target command front end (the QmTargetTrajectoriesPublisher node):
    converts user intent to TargetTrajectories on `device` with the
    reference's three conversions, holding the lastEeTarget state."""
    cfg: ReferenceConfig = field(default_factory=ReferenceConfig)
    last_ee_target: np.ndarray = field(
        default_factory=lambda: np.array([0.52, 0.09, 0.78,
                                          0.5, -0.5, 0.5, -0.5]))
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def goal_pose(self, ee_pos, ee_quat_wxyz, obs_time, obs_state,
                  ee_state) -> TargetTrajectory:
        """RViz interactive-marker 'send target pose' equivalent."""
        self.last_ee_target = np.concatenate(
            [np.asarray(ee_pos, dtype=np.float64),
             [ee_quat_wxyz[1], ee_quat_wxyz[2], ee_quat_wxyz[3],
              ee_quat_wxyz[0]]])
        return goal_pose_to_target(ee_pos, ee_quat_wxyz, obs_time,
                                   obs_state, ee_state, self.cfg,
                                   device=self.device)

    def cmd_vel(self, v, obs_time, obs_state, ee_state) -> TargetTrajectory:
        """Base velocity teleop (/cmd_vel equivalent)."""
        traj, self.last_ee_target = cmd_vel_to_target(
            v, self.last_ee_target, obs_time, obs_state, ee_state, self.cfg,
            device=self.device)
        return traj

    def ee_cmd_vel(self, v, obs_time, obs_state,
                   ee_state) -> TargetTrajectory:
        """EE velocity teleop (/ee_cmd_vel equivalent)."""
        traj, self.last_ee_target = ee_cmd_vel_to_target(
            v, self.last_ee_target, obs_time, obs_state, ee_state, self.cfg,
            device=self.device)
        return traj


class CommandQueue:
    """Thread-safe in-process command queue: the pub/sub replacement for
    the reference's ROS topics (SURVEY.md §5 comm backend)."""

    def __init__(self, maxsize: int = 64):
        self._q = queue.Queue(maxsize=maxsize)

    def publish(self, msg):
        # drop-oldest with retry: under concurrent publishers the freed
        # slot can be taken between get_nowait and put_nowait
        while True:
            try:
                self._q.put_nowait(msg)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()      # drop oldest
                except queue.Empty:
                    pass

    def drain(self):
        """All pending messages (newest last)."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                return out
