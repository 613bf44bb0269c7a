"""Whole-body control: task formulations, the interior-point QP, the
pivoted cascade and the hierarchical WBCs (port of qm_control_tpu/wbc)."""
from .qp import solve_qp  # noqa: F401
from .tasks import Task, WbcData, WbcDesired  # noqa: F401
from .wbc import HierarchicalWbc, hierarchical_wbc_update  # noqa: F401
