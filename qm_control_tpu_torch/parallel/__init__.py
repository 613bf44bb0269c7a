"""Scenario batching (port of qm_control_tpu/parallel): the single-scenario
MPC step, WBC update and closed-loop cycle lifted over a leading scenario
axis with torch.func.vmap. The JAX package's mesh sharding (mesh.py) and
multi-host scale-out (distributed.py) are not ported yet (ROADMAP).
"""
from .batch import (BatchScenario, make_batched_cycle,  # noqa: F401
                    make_batched_mpc_step, make_batched_wbc, stack_scenarios)
