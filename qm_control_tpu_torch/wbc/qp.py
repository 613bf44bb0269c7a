"""Dense inequality-constrained QP by a fixed-iteration Mehrotra
predictor-corrector interior point (port of qm_control_tpu/wbc/qp.py; the
replacement for the reference's qpOASES solves, qm_wbc/src/HoQp.cpp:135-150):

    minimize    0.5 x'Hx + c'x
    subject to  G x <= h

Every scenario of a batch runs the same fixed instruction stream: no
data-dependent control flow, no host read, so it runs under
torch.func.vmap. Robustness devices, as in the JAX module: Mehrotra
predictor-corrector with separate primal/dual step lengths; a convergence
gate (past convergence the step length is multiplied by 0); best-iterate
tracking by KKT merit; structurally inactive rows excluded from the IP
statistics; Jacobi equilibration.
"""
from typing import NamedTuple

import torch

EQUILIBRATE = True   # Jacobi equilibration (read at call time)


def _pd_inverse(M):
    """Inverse of a nominally-PD (n, n) matrix by Gauss-Jordan with
    diagonal pivoting (the largest remaining diagonal, ties toward the
    smallest index) and a pivot floor of 1e-10 (sum|diag| / n + 1): the
    no-NaN replacement for a Cholesky factorization, whose f32 Gram
    cancellation can push a weak leading-minor pivot negative. K1's plain
    version (kernels.hoqp_fused.cascade_plain) inverts with it too, so the
    two cascades share failure semantics. The pivot is an argmax and the
    row and column reads are index_select with a 1-element index: no host
    read, and a batch rule under vmap."""
    n = M.shape[0]
    floor = 1e-10 * (M.diagonal().abs().sum() / n + 1.0)
    aug = torch.cat([M, torch.eye(n, dtype=M.dtype, device=M.device)], dim=1)
    elim = torch.zeros(n, dtype=torch.bool, device=M.device)
    neg = torch.full((n,), -3e38, dtype=M.dtype, device=M.device)
    for _ in range(n):
        cand = torch.where(elim, neg, aug[:, :n].diagonal())
        p = torch.argmax(cand).reshape(1)          # first max = smallest index
        col = aug.index_select(1, p)[:, 0]
        piv = col.index_select(0, p)[0]
        piv = torch.where(piv.abs() < floor,
                          torch.where(piv < 0, -floor, floor), piv)
        row = aug.index_select(0, p)[0] / piv
        aug = aug - col[:, None] * row[None, :]
        aug = aug.index_copy(0, p, row[None, :])
        elim = elim.index_fill(0, p, True)
    return aug[:, n:]


def _pd_solve(Minv, M_mv, rhs):
    """Minv rhs with two iterative-refinement steps against the matvec
    M_mv (with a factor-form M_mv the refinement converges to the exact
    operator's solution; Minv only preconditions)."""
    x = Minv @ rhs
    x = x + Minv @ (rhs - M_mv(x))
    return x + Minv @ (rhs - M_mv(x))


class QpSolution(NamedTuple):
    x: torch.Tensor          # (n,) primal solution
    lam: torch.Tensor        # (m,) inequality multipliers
    s: torch.Tensor          # (m,) slacks  (G x + s = h)
    gap: torch.Tensor        # scalar final duality measure


def solve_qp(H, c, G, h, num_iters: int = 25, tau: float = 0.995,
             gate_tol: float = 1e-6, inactive_h: float = 5e5,
             H_mv=None) -> QpSolution:
    """Solve the inequality QP with `num_iters` fixed IP iterations.

    H (n, n), c (n,), G (m, n), h (m,). Structurally inactive rows (zero G
    rows, or bounds >= inactive_h: the contact-masking convention
    tasks.MASK_BIG) are excluded from the interior-point statistics; an
    excluded row is never tight, so the solution does not change. H_mv: an
    optional factor-form matvec of H (the refinement target)."""
    n = c.shape[0]
    dt = c.dtype
    eye_n = torch.eye(n, dtype=dt, device=c.device)

    act = ((G.abs().sum(1) > 1e-12) & (h < inactive_h)).to(dt)
    m_act = torch.clamp(act.sum(), min=1.0)
    G = G * act[:, None]
    h = torch.where(act > 0, h, torch.ones_like(h))   # inert: 0 x <= 1

    # Jacobi equilibration x = S x'', S = diag(1/sqrt(H_kk)): a pure
    # reparameterization that flattens the 1e10 spread of the WBC levels'
    # diagonal
    if EQUILIBRATE:
        s_eq = torch.rsqrt(torch.clamp(H.diagonal(), min=1e-12))
        H = H * s_eq[:, None] * s_eq[None, :]
        c = c * s_eq
        G = G * s_eq[None, :]
    else:
        s_eq = torch.ones_like(c)
    if H_mv is not None:
        def H_mv_eq(x):
            return s_eq * H_mv(s_eq * x)
    else:
        def H_mv_eq(x):
            return H @ x

    x = torch.linalg.solve_ex(H + 1e-8 * eye_n, -c)[0]
    s = torch.clamp(h - G @ x, min=1.0) * act + (1.0 - act)
    lam = act
    scale = torch.clamp(torch.linalg.vector_norm(c), min=1.0)

    def merit(x, s, lam):
        r_d = H_mv_eq(x) + c + G.T @ lam
        viol = torch.clamp(G @ x - h, min=0.0) * act
        return ((r_d * r_d).sum() + 100.0 * (viol * viol).sum()
                + (s * lam).abs().mul(act).sum())

    big = torch.full_like(h, 1e30)

    def maxstep(v, dv):
        """max alpha in [0, 1] with v + alpha dv >= 0 on active rows."""
        return torch.clamp(torch.where((dv < 0) & (act > 0), -v / dv,
                                       big).min(), max=1.0)

    bx, bs, blam, bm = x, s, lam, merit(x, s, lam)
    for _ in range(num_iters):
        s = torch.clamp(s, min=1e-9)
        lam = torch.clamp(lam, min=1e-12) * act
        r_d = H_mv_eq(x) + c + G.T @ lam
        r_p = (G @ x + s - h) * act
        mu = (s * act) @ lam / m_act
        # gate on the dual residual too: gating on (mu, r_p) alone freezes
        # warm-started iterates at the previous problem's optimum
        gate = torch.where((mu < gate_tol * scale)
                           & (r_p.abs().max() < gate_tol * scale)
                           & (r_d.abs().max() < 1e-4 * scale),
                           0.0, 1.0).to(dt)
        d = torch.clamp(lam / s, 1e-12, 1e8) * act
        M = H + G.T @ (d[:, None] * G)
        Minv = _pd_inverse(M)

        # the Newton solves refine against the MATERIALIZED M (a
        # factor-form residual would amplify f32 matvec noise by d ~ 1e8)
        def solveM(rhs):
            return _pd_solve(Minv, lambda v: M @ v, rhs)
        # predictor (affine direction)
        rc_aff = (-s * lam + lam * r_p) / s
        dx_a = solveM(-(r_d + G.T @ rc_aff))
        ds_a = -r_p - G @ dx_a
        dl_a = (-s * lam - lam * ds_a) / s
        ap_a = maxstep(s, ds_a)
        ad_a = maxstep(lam, dl_a)
        mu_aff = ((s + ap_a * ds_a) * act) @ (lam + ad_a * dl_a) / m_act
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-12)) ** 3,
                            1e-4, 1.0)
        # corrector
        rc = (sigma * mu - s * lam - ds_a * dl_a + lam * r_p) / s * act
        dx = solveM(-(r_d + G.T @ rc))
        ds = -r_p - G @ dx
        dlam = (sigma * mu - s * lam - ds_a * dl_a - lam * ds) / s * act
        ap = gate * tau * maxstep(s, ds)
        ad = gate * tau * maxstep(lam, dlam)
        x = x + ap * dx
        s = s + ap * ds
        lam = lam + ad * dlam
        mm = merit(x, s, lam)
        take = mm < bm
        bx = torch.where(take, x, bx)
        bs = torch.where(take, s, bs)
        blam = torch.where(take, lam, blam)
        bm = torch.minimum(mm, bm)
    return QpSolution(x=bx * s_eq, lam=blam, s=bs,
                      gap=(bs * act) @ blam / m_act)


def solve_eq_qp(H, c):
    """Equality/unconstrained helper: x = -H^{-1} c (H PSD + ridge)."""
    n = c.shape[0]
    return torch.linalg.solve_ex(
        H + 1e-8 * torch.eye(n, dtype=c.dtype, device=c.device), -c)[0]
