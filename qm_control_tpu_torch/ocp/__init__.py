"""Optimal-control-problem layer: targets, costs, constraints, assembly
(port of qm_control_tpu/ocp)."""
from .reference import TargetTrajectory, target_from_knots  # noqa: F401
from .problem import OcpParams, make_ocp  # noqa: F401
