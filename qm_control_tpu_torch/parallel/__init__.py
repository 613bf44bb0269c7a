"""Scenario batching and scale-out (port of qm_control_tpu/parallel): the
single-scenario MPC step, WBC update and closed-loop cycle lifted over a
leading scenario axis with torch.func.vmap (batch.py); the scenario batch
sharded over a 1-D "dp" DeviceMesh, one rank per device (mesh.py); and
multi-process initialization with explicit all-reduce metrics
(distributed.py).
"""
from .batch import (BatchScenario, make_batched_cycle,  # noqa: F401
                    make_batched_mpc_step, make_batched_wbc, stack_scenarios)
from .mesh import make_mesh, shard_scenarios, sharded_mpc_step  # noqa: F401
