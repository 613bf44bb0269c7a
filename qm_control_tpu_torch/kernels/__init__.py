"""Hand-written Hopper kernels of the port.

hoqp_fused (K1): the 3-level hierarchical-WBC QP cascade in one CUDA
launch (replaces the Pallas kernel qm_control_tpu/kernels/hoqp_fused.py).
"""
from .hoqp_fused import cascade_plain, fused_hoqp  # noqa: F401
