"""3x3 algebra (port of qm_control_tpu/models/smallmat.py).

The JAX module unrolls the 3x3 products into elementwise arithmetic
because XLA on a TPU lowers tiny batched matmuls poorly. In eager PyTorch
every elementwise op is a separate launch (and, under torch.func, a
separate batching-rule dispatch), so the products here are one batched
matmul each; the Cramer inverse stays written out. Every function
broadcasts over leading batch dims and is functional under torch.func
transforms.
"""
import torch


def mm3(A, B):
    """(...,3,3) @ (...,3,3), broadcasting over leading dims."""
    return torch.matmul(A, B)


def mv3(A, v):
    """(...,3,3) @ (...,3)."""
    return torch.matmul(A, v[..., None])[..., 0]


def mtv3(A, v):
    """A^T @ v for (...,3,3), (...,3)."""
    return torch.matmul(A.transpose(-1, -2), v[..., None])[..., 0]


def det3(A):
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


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


def solve3(A, b, eps=0.0):
    """A^{-1} b for (...,3,3), (...,3) via Cramer."""
    return mv3(inv3(A, eps=eps), b)


def solve3_spd_damped(A, b, damp):
    """(A + damp I)^{-1} b."""
    return solve3(A + damp * torch.eye(3, dtype=A.dtype, device=A.device), b)


# ---------------------------------------------------------------------------
# Medium-small matrices (n ~ 30) of the Riccati sweep (solver/sqp.py).
# The JAX module unrolls the four products into sums of outer products for
# the TPU's vector unit; they are the same functions as a matmul and are one
# here. The Cholesky factor keeps the JAX semantics: each pivot is
# sqrt(max(diag, 1e-12)) and the entries not yet computed are zero.
# ---------------------------------------------------------------------------


def mm_unrolled(A, B):
    """A @ B for (..., n, k) x (..., k, m)."""
    return torch.matmul(A, B)


def mv_unrolled(A, v):
    """A @ v for (..., n, k) x (..., k)."""
    return torch.matmul(A, v[..., None])[..., 0]


def mtv_unrolled(A, v):
    """A^T @ v for (..., n, k), (..., n) -> (..., k)."""
    return torch.matmul(A.transpose(-1, -2), v[..., None])[..., 0]


def mtm_unrolled(A, B):
    """A^T @ B for (..., k, n) x (..., k, m)."""
    return torch.matmul(A.transpose(-1, -2), B)


def cholesky_unrolled(A):
    """Lower Cholesky factor of SPD (..., n, n), pivot by pivot (right-
    looking: each pivot's column, then the rank-1 update of the trailing
    block). A pivot whose remaining diagonal is below 1e-12 is clamped to
    sqrt(1e-12) (the JAX module's rule), so the factor stays finite on a
    semidefinite A; entries above the diagonal are zero."""
    n = A.shape[-1]
    S = A.clone()
    L = torch.zeros_like(A)
    for j in range(n):
        ljj = torch.sqrt(torch.clamp(S[..., j, j], min=1e-12))
        L[..., j, j] = ljj
        if j + 1 < n:
            col = S[..., j + 1:, j] / ljj[..., None]
            L[..., j + 1:, j] = col
            S[..., j + 1:, j + 1:] -= col[..., :, None] * col[..., None, :]
    return L


def cho_solve_unrolled(L, B):
    """Solve A X = B given A = L L^T, for B (..., n, m): forward and back
    substitution."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def spd_solve_unrolled(A, B):
    """A^{-1} B for SPD A (..., n, n), B (..., n, m)."""
    return cho_solve_unrolled(cholesky_unrolled(A), B)
