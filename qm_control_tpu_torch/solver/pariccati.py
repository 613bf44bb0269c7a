"""Parallel-scan (associative) Riccati sweeps (port of
qm_control_tpu/solver/pariccati.py; Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Dynamic Programming and Linear Quadratic Control",
2021).

The serial backward recursion is a chain of N dependent 30x30 steps. Here
the value recursion is an associative combination of conditional-value
elements, so `associative_scan` evaluates the whole horizon in
ceil(log2 N) rounds of batched matrix algebra (7 rounds for N = 67); the
per-node gains then come from one batched pass. The affine forward
rollout is a prefix composition of (M, v) affine maps.

Semantics match solver.sqp's serial backward / linear forward (defects d
as affine offsets, the Quu ridge). `associative_scan` follows
jax.lax.associative_scan's odd/even recursion, so the elements combine in
the JAX package's order. Everything is batched tensor algebra
(torch.linalg.solve_ex, no host read), so it runs under torch.func.vmap.

Element covering a stage interval [i, j):
    psi(x_i, x_j) = 0.5 x_i'J x_i - eta'x_i  [+ boundary coupling
    x_j = A x_i + b with quadratic relaxation C]
Combination (e1 earlier, e2 later; S = I + C1 J2):
    A  = A2 S^-1 A1
    b  = A2 S^-1 (b1 + C1 eta2) + b2
    C  = A2 S^-1 C1 A2' + C2
    eta = A1' (I + J2 C1)^-1 (eta2 - J2 b1) + eta1
    J  = A1' (I + J2 C1)^-1 J2 A1 + J1
"""
from typing import NamedTuple

import torch


class _Elem(NamedTuple):
    A: torch.Tensor     # (N, nx, nx)
    b: torch.Tensor     # (N, nx)
    C: torch.Tensor     # (N, nx, nx)
    eta: torch.Tensor   # (N, nx)
    J: torch.Tensor     # (N, nx, nx)


def _rebuild(like, parts):
    parts = list(parts)
    return type(like)(*parts) if hasattr(like, "_fields") else tuple(parts)


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 0 (len(a) is len(b) or one
    more)."""
    n = b.shape[0]
    out = torch.stack([a[:n], b], dim=1).reshape(2 * n, *a.shape[1:])
    return torch.cat([out, a[n:]]) if a.shape[0] > n else out


def associative_scan(fn, elems, reverse: bool = False):
    """jax.lax.associative_scan(fn, elems, reverse, axis=0) for a tuple (or
    NamedTuple) of tensors with a common leading axis: element k of the
    result is fn applied to the first k + 1 elements, in JAX's order of
    combination. reverse=True flips the sequence before and after, so fn's
    first operand is then the LATER element."""
    if reverse:
        elems = _rebuild(elems, (torch.flip(e, (0,)) for e in elems))

    def scan(elems):
        n = elems[0].shape[0]
        if n < 2:
            return elems
        # combine adjacent pairs, scan the half-length sequence (the odd
        # results), then each even result from its odd predecessor
        odd = scan(fn(_rebuild(elems, (e[0:-1:2] for e in elems)),
                      _rebuild(elems, (e[1::2] for e in elems))))
        evens = _rebuild(elems, (e[2::2] for e in elems))
        if n % 2 == 0:
            even = fn(_rebuild(elems, (o[:-1] for o in odd)), evens)
        else:
            even = fn(odd, evens)
        even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
        return _rebuild(elems, (_interleave(e, o) for e, o in zip(even, odd)))

    out = scan(elems)
    if reverse:
        out = _rebuild(out, (torch.flip(e, (0,)) for e in out))
    return out


def _solve(A, B):
    return torch.linalg.solve_ex(A, B)[0]     # no error check: no sync


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """e1 covers the EARLIER interval, e2 the later one."""
    nx = e1.A.shape[-1]
    eye = torch.eye(nx, dtype=e1.A.dtype, device=e1.A.device)
    S = eye + e1.C @ e2.J
    Sinv_A1 = _solve(S, e1.A)
    Sinv_bCe = _solve(S, (e1.b + _mv(e1.C, e2.eta))[..., None])[..., 0]
    Sinv_C1 = _solve(S, e1.C)
    # (I + J2 C1) = S' since C and J are symmetric: reuse S'
    St = S.transpose(-1, -2)
    T = _solve(St, (e2.eta - _mv(e2.J, e1.b))[..., None])[..., 0]
    JA = _solve(St, e2.J @ e1.A)
    A1t = e1.A.transpose(-1, -2)
    A = e2.A @ Sinv_A1
    b = _mv(e2.A, Sinv_bCe) + e2.b
    C = e2.A @ Sinv_C1 @ e2.A.transpose(-1, -2) + e2.C
    eta = _mv(A1t, T) + e1.eta
    J = A1t @ JA + e1.J
    # symmetrize the accumulated quadratics (f32 drift)
    C = 0.5 * (C + C.transpose(-1, -2))
    J = 0.5 * (J + J.transpose(-1, -2))
    return _Elem(A, b, C, eta, J)


def parallel_backward(A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN, reg):
    """Gains (kffs (N, nw), Kfbs (N, nw, nx)) equivalent to the serial
    defect-aware Riccati sweep of solver.sqp. All arrays stacked over the
    N stages."""
    nx = A.shape[-1]
    nw = B.shape[-1]
    f = dict(dtype=A.dtype, device=A.device)
    eye_w = torch.eye(nw, **f)
    Bt, luxt = B.transpose(-1, -2), lux.transpose(-1, -2)

    luu_reg = 0.5 * (luu + luu.transpose(-1, -2)) + reg * eye_w
    kK0 = _solve(luu_reg, torch.cat([lu[..., None], lux], dim=-1))
    k0, K0 = kK0[..., 0], kK0[..., 1:]
    elems = _Elem(A=A - B @ K0, b=d - _mv(B, k0),
                  C=B @ _solve(luu_reg, Bt),
                  eta=-(lx - _mv(luxt, k0)), J=lxx - luxt @ K0)
    term = _Elem(A=torch.zeros((1, nx, nx), **f), b=torch.zeros((1, nx), **f),
                 C=torch.zeros((1, nx, nx), **f), eta=-VxN[None],
                 J=VxxN[None])
    full = _Elem(*[torch.cat([a, t]) for a, t in zip(elems, term)])

    # suffix compositions suffix_k = e_k (x) ... (x) e_T -> V_k; under
    # reverse the scan's first operand is the later element: swap into
    # _combine's (earlier, later) order
    suf = associative_scan(lambda a, b: _combine(b, a), full, reverse=True)
    Vx1, Vxx1 = -suf.eta[1:], suf.J[1:]      # V_{k+1} for stage k

    Vxd = Vx1 + _mv(Vxx1, d)
    Qu = lu + _mv(Bt, Vxd)
    Quu = luu + Bt @ (Vxx1 @ B)
    Qux = lux + Bt @ (Vxx1 @ A)
    Quu_reg = 0.5 * (Quu + Quu.transpose(-1, -2)) + reg * eye_w
    kK = _solve(Quu_reg, torch.cat([Qu[..., None], Qux], dim=-1))
    return -kK[..., 0], -kK[..., 1:]


def parallel_linear_forward(X, W, A, B, d, kffs, Kfbs, alpha):
    """dx' = A dx + B dw + alpha d;  dw = alpha k + K dx as a prefix
    composition of affine maps (M, v): (M2, v2) o (M1, v1) =
    (M2 M1, M2 v1 + v2). Matches solver.sqp's linear forward pass."""
    M = A + B @ Kfbs
    v = alpha * (_mv(B, kffs) + d)

    def comp(p1, p2):
        M1, v1 = p1
        M2, v2 = p2
        return (M2 @ M1, _mv(M2, v1) + v2)

    _, vp = associative_scan(comp, (M, v))
    # dx_0 = 0, dx_{k+1} = vp_k
    dX = torch.cat([torch.zeros_like(vp[:1]), vp])
    dW = alpha * kffs + _mv(Kfbs, dX[:-1])
    return X + dX, W + dW
