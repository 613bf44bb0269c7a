from .mpc import MpcPolicy, evaluate_policy  # noqa: F401
