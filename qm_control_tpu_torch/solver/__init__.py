"""Trajectory-optimization solvers (port of qm_control_tpu/solver): the
multiple-shooting SQP with its Riccati LQ backend."""
from .sqp import SqpSettings, SqpSolution, sqp_solve  # noqa: F401
