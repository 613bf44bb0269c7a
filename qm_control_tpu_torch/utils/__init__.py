"""Utilities: timers and trajectory logs (port of qm_control_tpu/utils)."""
from .timers import RepeatedTimer  # noqa: F401
from .viz import TrajectoryLog, export_trajectory  # noqa: F401
