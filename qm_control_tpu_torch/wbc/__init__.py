"""Whole-body control: task formulations and the hierarchical WBC
(port of qm_control_tpu/wbc)."""
from .tasks import Task, WbcData, WbcDesired  # noqa: F401
from .wbc import HierarchicalWbc, hierarchical_wbc_update  # noqa: F401
