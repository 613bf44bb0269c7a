"""Exact-shape hierarchical-WBC cascade in plain PyTorch (port of
qm_control_tpu/kernels/cascade_exact.py).

The same no-pivot cascade math as K1 (kernels.hoqp_fused: the shared
Mehrotra IP `_ip_solve`, the diagonal-pivot Gauss-Jordan with its pivot
floor, the ridge and projector damping), written as the JAX package's
batch path writes it: the pivot row of each Gauss-Jordan step is picked
with a one-hot vector and matrix products instead of an argmax and a
gather, so every scenario of a `torch.func.vmap` batch does identical
work. This is what `fused_cascade="xla"` / `LoopConfig.fused_wbc="xla"`
run, and `fused_hoqp_batched` on CPU tensors.

Warm starts: `ExactWarm` carries the nine rows of K1's (9, W) warm buffer
(hoqp_fused module docstring) as named fields; `warm_to_buffer` and
`warm_from_buffer` convert between the two.
"""
from typing import NamedTuple, Optional

import torch

from ..wbc.tasks import NUM_DECISION_VARS, Task
from .hoqp_fused import _EPS_H, _EPS_NULL, _ip_solve, warm_width


def _gj_inverse_exact(M, floor_rel=1e-10):
    """Diagonal-pivot Gauss-Jordan inverse of an SPD (n,n) matrix with a
    pivot floor of floor_rel * (trace / n + 1); the pivot (the largest
    remaining diagonal, ties toward the smallest index) is selected with a
    one-hot vector."""
    n = M.shape[-1]
    dt, dev = M.dtype, M.device
    rank = n - torch.arange(n, dtype=dt, device=dev)
    floor = floor_rel * (M.diagonal().sum() / n + 1.0)
    L, R = M, torch.eye(n, dtype=dt, device=dev)
    elim = torch.zeros(n, dtype=dt, device=dev)
    for _ in range(n):
        cand = torch.where(elim > 0, -3e38, L.diagonal())
        ismax = (cand >= cand.max()).to(dt)
        score = ismax * rank
        onehot = (score >= score.max()).to(dt) * ismax
        colL = L @ onehot
        rowL = onehot @ L
        rowR = onehot @ R
        piv = colL @ onehot
        piv = torch.where(piv.abs() < floor,
                          torch.where(piv < 0, -floor, floor), piv)
        rL = rowL / piv
        rR = rowR / piv
        oc = onehot[:, None] > 0
        L = torch.where(oc, rL[None, :], L - colL[:, None] * rL[None, :])
        R = torch.where(oc, rR[None, :], R - colL[:, None] * rR[None, :])
        elim = elim + onehot
    return R


def _refined(Minv, M, rhs):
    x = Minv @ rhs
    return x + Minv @ (rhs - M @ x)


class ExactWarm(NamedTuple):
    """Tick-to-tick warm carry (hoqp_fused._ip_solve's warm contract).
    valid=0 reproduces the cold path bit for bit."""
    valid: torch.Tensor     # scalar: 1 after the first solve
    z0: torch.Tensor        # (36,)
    v0: torch.Tensor        # (nv,)
    lam_a: torch.Tensor     # (nv,)
    lam_b: torch.Tensor     # (nv,)
    z1: torch.Tensor        # (36,)
    lam1: torch.Tensor      # (nv,)
    z2: torch.Tensor        # (36,)
    lam2: torch.Tensor      # (nv,)


def zero_warm(nv: int = 56, device="cuda") -> ExactWarm:
    from .. import resolve_device
    dev = resolve_device(device)
    z = torch.zeros(NUM_DECISION_VARS, dtype=torch.float32, device=dev)
    v = torch.zeros(nv, dtype=torch.float32, device=dev)
    return ExactWarm(torch.zeros((), dtype=torch.float32, device=dev),
                     z, v, v, v, z, v, z, v)


def warm_to_buffer(warm: ExactWarm) -> torch.Tensor:
    """ExactWarm -> K1's (9, max(nv, 36)) warm buffer (the same rows in the
    same order, zero-padded; row 0 is the validity in every lane)."""
    W = warm_width(warm.v0.shape[-1])
    rows = [torch.nn.functional.pad(r, (0, W - r.shape[-1]))
            for r in warm[1:]]
    return torch.stack([warm.valid[..., None].expand(rows[0].shape)] + rows,
                       dim=-2)


def warm_from_buffer(buf: torch.Tensor, nv: int = 56) -> ExactWarm:
    """K1's (9, W) warm buffer -> ExactWarm; the validity is the row-0
    maximum clamped at 1, as K1 and cascade_plain read it."""
    nx = NUM_DECISION_VARS
    r = buf.unbind(-2)
    return ExactWarm(torch.clamp(r[0].amax(-1), max=1.0), r[1][..., :nx],
                     r[2][..., :nv], r[3][..., :nv], r[4][..., :nv],
                     r[5][..., :nx], r[6][..., :nv], r[7][..., :nx],
                     r[8][..., :nv])


def cascade_exact(t0: Task, t1: Task, t2: Task, qp_iters: int = 10,
                  warm: Optional[ExactWarm] = None,
                  return_warm: bool = False):
    """Solve the 3-level cascade (inequalities at level 0 only) on exact
    shapes; returns the (36,) decision vector, or (x, ExactWarm)."""
    if t1.D.shape[0] != 0 or t2.D.shape[0] != 0:
        raise ValueError("cascade_exact supports inequalities at level 0 only")
    nx = NUM_DECISION_VARS
    A0, b0, D, f = t0.A, t0.b, t0.D, t0.f
    dt, dev = A0.dtype, A0.device
    nv = D.shape[0]
    eye = torch.eye(nx, dtype=dt, device=dev)
    dmask = (f < 5e5).to(dt)
    n_act = torch.clamp(dmask.sum(), min=1.0)

    def projector(Az):
        ma = Az.shape[0]
        gram = Az @ Az.T
        lam_r = _EPS_NULL * (gram.diagonal().sum() / ma + 1.0)
        inv = _gj_inverse_exact(gram + lam_r * torch.eye(ma, dtype=dt,
                                                         device=dev))
        return eye - Az.T @ (inv @ Az)

    def level_data(A, b, Z, x):
        Az = A @ Z
        gram = Az.T @ Az
        ridge = _EPS_H * (gram.diagonal().max() + 1e-3)
        Hz = gram + ridge * eye
        cz = Az.T @ (A @ x - b)

        def hz_mv(z):
            return Az.T @ (Az @ z) + ridge * z

        return Az, Hz, cz, hz_mv

    def init_solve(Hz, cz, hz_mv):
        inv0 = _gj_inverse_exact(Hz)
        x = inv0 @ (-cz)
        for _ in range(2):
            x = x + inv0 @ (-cz - hz_mv(x))
        return x

    def eq_level_solve(Hz, cz, hz_mv, B, h, wz, wlam):
        def Gmv(z):
            return ((B @ z[0]) * dmask,)

        def GTmv(y):
            return (B.T @ y[0],)

        def solveM(d, rhs):
            S = Hz + B.T @ (d[0][:, None] * B)
            return (_refined(_gj_inverse_exact(S), S, rhs[0]),)

        scale = torch.clamp(torch.linalg.vector_norm(cz), min=1.0)
        x0 = (init_solve(Hz, cz, hz_mv),)
        lvl_warm = None if warm is None else (warm.valid, (wz,),
                                              (wlam * dmask,))
        bx, _, blam = _ip_solve(x0, (cz,), (h,), (dmask,), n_act,
                                lambda z: (hz_mv(z[0]),), Gmv, GTmv, solveM,
                                scale, qp_iters, warm=lvl_warm)
        return bx[0], blam[0]

    # ---------------- level 0: (z, v) with slack v ----------------
    x = torch.zeros(nx, dtype=dt, device=dev)
    Z = eye
    Az0, Hz0, cz0, hz0_mv = level_data(A0, b0, Z, x)

    def Hmv0(xz):
        z, v = xz
        return (hz0_mv(z), v)

    def Gmv0(xz):
        z, v = xz
        return (-v, (D @ z - v) * dmask)

    def GTmv0(y):
        y1, y2 = y
        return (D.T @ (y2 * dmask), -y1 - y2)

    def solveM0(d, rhs):
        d1, d2 = d
        rz, rv = rhs
        mvv = 1.0 + d1 + d2
        w = d2 * (1.0 + d1) / mvv
        S = Hz0 + D.T @ (w[:, None] * D)
        rz_s = rz + D.T @ (d2 * rv / mvv)
        dz = _refined(_gj_inverse_exact(S), S, rz_s)
        return (dz, (rv + d2 * (D @ dz)) / mvv)

    zeros_v = torch.zeros(nv, dtype=dt, device=dev)
    h0 = (zeros_v, torch.where(dmask > 0, f, torch.ones_like(f)))
    scale0 = torch.clamp(torch.linalg.vector_norm(cz0), min=1.0)
    x0_init = (init_solve(Hz0, cz0, hz0_mv), zeros_v)
    warm0 = None if warm is None else (
        warm.valid, (warm.z0, warm.v0), (warm.lam_a, warm.lam_b * dmask))
    (z0s, v0s), _, (lam_as, lam_bs) = _ip_solve(
        x0_init, (cz0, zeros_v), h0, (torch.ones_like(zeros_v), dmask),
        nv + n_act, Hmv0, Gmv0, GTmv0, solveM0, scale0, qp_iters,
        warm=warm0)
    x = x + Z @ z0s
    Z = Z @ projector(Az0)

    def carried_h(x):
        hq = f - D @ x + v0s
        return torch.where(dmask > 0, torch.clamp(hq, min=0.0),
                           torch.ones_like(hq))

    # ---------------- levels 1, 2 ----------------
    Az1, Hz1, cz1, hz1_mv = level_data(t1.A, t1.b, Z, x)
    z1s, lam1s = eq_level_solve(Hz1, cz1, hz1_mv, D @ Z, carried_h(x),
                                None if warm is None else warm.z1,
                                None if warm is None else warm.lam1)
    x = x + Z @ z1s
    Z = Z @ projector(Az1)

    _, Hz2, cz2, hz2_mv = level_data(t2.A, t2.b, Z, x)
    z2s, lam2s = eq_level_solve(Hz2, cz2, hz2_mv, D @ Z, carried_h(x),
                                None if warm is None else warm.z2,
                                None if warm is None else warm.lam2)
    x = x + Z @ z2s
    if not return_warm:
        return x
    return x, ExactWarm(torch.ones((), dtype=dt, device=dev), z0s, v0s,
                        lam_as, lam_bs, z1s, lam1s, z2s, lam2s)
