"""Trajectory-optimization solvers (port of qm_control_tpu/solver): the
multiple-shooting SQP with its Riccati LQ backend (serial or the
associative scan of pariccati.py) and the single-shooting iLQR."""
from .ilqr import IlqrSettings, IlqrSolution, ilqr_solve  # noqa: F401
from .sqp import SqpSettings, SqpSolution, sqp_solve  # noqa: F401
