"""Hand-written Hopper kernels of the port, and the plain cascades beside
them.

hoqp_fused (K1): the 3-level hierarchical-WBC QP cascade in one CUDA
launch (replaces the Pallas kernel qm_control_tpu/kernels/hoqp_fused.py);
a batch of B cascades is one launch with grid = B. cascade_exact: the
same cascade in plain PyTorch on exact shapes, the JAX package's batch
path.
"""
from .hoqp_fused import cascade_plain, fused_hoqp, fused_hoqp_batched  # noqa: F401
