"""MPC layer: policy solve, warm start, MRT-style policy evaluation
(port of qm_control_tpu/mpc)."""
from .mpc import MpcPolicy, MpcSolver, evaluate_policy, mpc_step  # noqa: F401
