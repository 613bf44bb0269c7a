"""Runtime: plant, ground-truth estimator, safety and the real-time tick
loop (port of qm_control_tpu/runtime)."""
from .estimator import observation_from_rbd, rbd_state_from_plant  # noqa: F401
from .loop import ControlLoop, LoopConfig  # noqa: F401
from .plant import PlantConfig, PlantState, hybrid_torque, make_plant_step  # noqa: F401
from .safety import safety_check  # noqa: F401
