"""Hierarchical (lexicographic) null-space QP cascade, the pivoted
reference cascade (port of qm_control_tpu/wbc/hoqp.py; reference
qm_wbc/src/HoQp.cpp:12-158):

  level p:  min_z,v  0.5|A_p(x + Z z) - b_p|^2 + 0.5|v|^2
            s.t.     D_p(x + Z z) <= f_p + v,   v >= 0,
                     D_q(x + Z z) <= f_q + v_q*   for all q < p

  then x <- x + Z z*,  Z <- Z P  with P the damped projector onto
  ker(A_p Z).

Each level is solved by the fixed-iteration interior point of qp.py on
its full KKT system (decision variables and slacks, Gauss-Jordan with
diagonal pivoting), where K1 (kernels.hoqp_fused) eliminates the slacks
by a Schur complement. Static shapes, no host read: it runs under
torch.func.vmap (parallel.make_batched_wbc(cascade="hoqp")).
"""
from typing import List, Sequence

import torch

from .qp import solve_qp
from .tasks import NUM_DECISION_VARS, Task

# relative ridge on the level Hessian, scaled by the Gram's max diagonal
# (the f32 Gram's rounding can flip weak eigenvalues negative; 3e-6 is the
# JAX package's measured sweet spot against its f64 referee)
_EPS_H = 3e-6
# damping of the null-space projector (through an LU solve: nonsingularity
# is what matters; more damping adds torque bias)
_EPS_NULL = 1e-7
# clamp carried inequality slacks h_q = f_q - D_q x + v_q* to >= 0 (a
# negative value is f32 drift and makes the origin infeasible)
CLAMP_CARRIED = True
# exact-zero QR kernel basis instead of the damped projector (off: the
# projector is the more accurate cascade against the f64 referee)
USE_QR_BASIS = False
DEFAULT_QP_ITERS = 10   # IP iterations per level (read at call time)


def _kernel_projector(Az):
    """P ~ I - Az^+ Az with a damped pseudo-inverse (masked zero rows do
    not reduce the kernel)."""
    m, n = Az.shape
    f = dict(dtype=Az.dtype, device=Az.device)
    gram = Az @ Az.T
    lam = _EPS_NULL * (gram.diagonal().sum() / m + 1.0)
    inv = torch.linalg.solve_ex(gram + lam * torch.eye(m, **f), Az)[0]
    return torch.eye(n, **f) - Az.T @ inv


def _kernel_basis(Az, rel_tol=1e-5):
    """Orthonormal basis of ker(Az) as an (n, n) matrix whose non-kernel
    columns are exact zeros: the column-pivoted Householder QR of
    kernels.hoqp_fused._kernel_basis_qr."""
    from ..kernels.hoqp_fused import _kernel_basis_qr
    return _kernel_basis_qr(Az, rel_tol=rel_tol)


def hoqp_solve(tasks: Sequence[Task], qp_iters: int = None):
    """Solve the lexicographic cascade, tasks ordered highest priority
    first. Returns the optimal decision vector x (36,). qp_iters: the
    fixed IP iteration count per level (default DEFAULT_QP_ITERS)."""
    nx = NUM_DECISION_VARS
    f = dict(dtype=tasks[0].A.dtype, device=tasks[0].A.device)
    if qp_iters is None:
        qp_iters = DEFAULT_QP_ITERS
    x = torch.zeros(nx, **f)
    Z = torch.eye(nx, **f)
    prev: List = []    # [(D, f, v_opt)] accumulated inequality levels

    for task in tasks:
        ma, nv = task.A.shape[0], task.D.shape[0]
        Az = task.A @ Z                                   # (ma, nx)
        gram = Az.T @ Az
        ridge = _EPS_H * (gram.diagonal().max() + 1e-3)
        H_z = gram + ridge * torch.eye(nx, **f)
        c_z = Az.T @ (task.A @ x - task.b)

        G_rows, h_rows = [], []
        if nv > 0:                                        # -v <= 0
            G_rows.append(torch.cat([torch.zeros(nv, nx, **f),
                                     -torch.eye(nv, **f)], dim=1))
            h_rows.append(torch.zeros(nv, **f))
        for (Dq, fq, vq) in prev:
            G_rows.append(torch.cat(
                [Dq @ Z, torch.zeros(Dq.shape[0], nv, **f)], dim=1))
            hq = fq - Dq @ x + vq
            h_rows.append(torch.clamp(hq, min=0.0) if CLAMP_CARRIED else hq)
        if nv > 0:
            G_rows.append(torch.cat([task.D @ Z, -torch.eye(nv, **f)], dim=1))
            h_rows.append(task.f - task.D @ x)

        H = torch.cat([torch.cat([H_z, torch.zeros(nx, nv, **f)], dim=1),
                       torch.cat([torch.zeros(nv, nx, **f),
                                  torch.eye(nv, **f)], dim=1)])
        c = torch.cat([c_z, torch.zeros(nv, **f)])

        def H_mv(zv, Az=Az, ridge=ridge, nv=nv):
            """Factor-form H matvec Az'(Az z) + ridge z (+ the slack
            block's identity): the refinement target (qp._pd_solve)."""
            z = zv[:nx]
            out_z = Az.T @ (Az @ z) + ridge * z
            return out_z if nv == 0 else torch.cat([out_z, zv[nx:]])

        if G_rows:
            sol = solve_qp(H, c, torch.cat(G_rows), torch.cat(h_rows),
                           num_iters=qp_iters, H_mv=H_mv)
            zv = sol.x
        else:
            zv = torch.linalg.solve_ex(H, -c)[0]
        z, v = zv[:nx], zv[nx:]

        x = x + Z @ z
        if nv > 0:
            prev.append((task.D, task.f, v))
        if ma > 0:
            Z = Z @ (_kernel_basis(Az) if USE_QR_BASIS
                     else _kernel_projector(Az))
    return x
