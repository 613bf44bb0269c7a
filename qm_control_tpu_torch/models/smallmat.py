"""3x3 algebra (port of qm_control_tpu/models/smallmat.py).

The JAX module unrolls the 3x3 products into elementwise arithmetic
because XLA on a TPU lowers tiny batched matmuls poorly. In eager PyTorch
every elementwise op is a separate launch (and, under torch.func, a
separate batching-rule dispatch), so the products here are one batched
matmul each; the Cramer inverse stays written out. Every function
broadcasts over leading batch dims and is functional under torch.func
transforms. The medium-size Riccati helpers (`spd_solve_unrolled`) come
with the MPC slice.
"""
import torch


def mm3(A, B):
    """(...,3,3) @ (...,3,3), broadcasting over leading dims."""
    return torch.matmul(A, B)


def mv3(A, v):
    """(...,3,3) @ (...,3)."""
    return torch.matmul(A, v[..., None])[..., 0]


def inv3(A, eps=0.0):
    """Cramer inverse of (...,3,3); eps floors |det| (sign preserved)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c02 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c10 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c20 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c21 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c01 + A[..., 0, 2] * c02
    if eps:
        det = torch.sign(torch.where(det == 0, torch.ones_like(det), det)) \
            * torch.clamp(det.abs(), min=eps)
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    return adj * inv_det[..., None, None]
