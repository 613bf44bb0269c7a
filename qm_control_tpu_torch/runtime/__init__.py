"""Runtime: plant, ground-truth estimator, safety, the control loop and
the MPC-only variant's loop (port of qm_control_tpu/runtime)."""
from .estimator import observation_from_rbd, rbd_state_from_plant  # noqa: F401
from .loop import ControlLoop, LoopConfig  # noqa: F401
from .mpc_loop import MpcControlLoop  # noqa: F401
from .plant import PlantConfig, PlantState, hybrid_torque, make_plant_step  # noqa: F401
from .safety import safety_check  # noqa: F401
