"""Multiple-shooting SQP (Gauss-Newton) with a Riccati LQ backend (port of
qm_control_tpu/solver/sqp.py; OCS2's SqpMpc, reference task.info:75-92).

The state trajectory is a decision variable and the dynamics enter as
defects d_k = f(x_k, w_k) - x_{k+1}, driven to 0 by the SQP, so an
unstable system never produces a diverging rollout. One iteration:
  1. linearize the dynamics and quadratize the cost at (X, W), vmapped
     over the nodes (torch.func.vmap);
  2. the Riccati backward sweep with defect (affine) terms, a Python loop
     over the nodes (or, with SqpSettings.parallel_riccati, the
     associative scan of solver/pariccati.py);
  3. the line search: every step length alpha runs the linear forward pass
     dw = alpha k + K dx, dx' = A dx + B dw + alpha d (all candidates at
     once, batched along a leading axis), its merit is evaluated for all
     candidates and nodes in one vmapped call, and the filter picks the
     step. The pick stays on the device (no host read).
"""
import contextlib
from typing import NamedTuple

import torch
from torch.func import vmap
from torch.profiler import record_function

from ..utils.graphs import segment


class SqpSettings(NamedTuple):
    num_iterations: int = 1          # task.info sqp.sqpIteration
    reg: float = 1e-5                # Levenberg shift on Quu
    merit_nu: float = 1e4            # L1 defect penalty of the merit
    # filter line search (OCS2's acceptance rule; the reference's
    # task.info:82-83 g_max/g_min): cost progress is accepted while the
    # defects stay within g_max, defects are driven first above it
    g_max: float = 1e-2
    g_min: float = 1e-6
    alphas: tuple = (1.0, 0.5, 0.15, 0.03)   # step-length candidates
    # True: the Riccati helpers of models/smallmat (the pivot-by-pivot
    # Cholesky with its clamp, the JAX package's default). False: LU
    # solves (torch.linalg.solve_ex), fewer and larger launches.
    unrolled_ops: bool = True
    # True: the associative-scan Riccati and prefix-scan rollout of
    # solver/pariccati.py, ceil(log2 N) rounds of batched solves instead of
    # N dependent steps
    parallel_riccati: bool = False


class SqpSolution(NamedTuple):
    X: torch.Tensor          # (N+1, nx)
    W: torch.Tensor          # (N, nw)
    cost: torch.Tensor       # scalar: cost at the returned iterate
    defect: torch.Tensor     # scalar: max |defect| at the returned iterate
    K: torch.Tensor          # (N, nw, nx) feedback gains of the last sweep
    alpha: torch.Tensor      # accepted step length of the last iteration


_ALPHAS = {}


def _alphas(values, like):
    """The step-length candidates as a tensor like `like`, made once."""
    key = (tuple(values), like.device, like.dtype)
    if key not in _ALPHAS:
        _ALPHAS[key] = torch.tensor(values, dtype=like.dtype,
                                    device=like.device)
    return _ALPHAS[key]


@contextlib.contextmanager
def _stage(name):
    """The record_function range of one stage, which names it in a
    torch.profiler trace (~1 us when no profiler runs); under a CUDA-graph
    capture the stage's segment begins here (utils/graphs.segment)."""
    segment(name)
    with record_function(name):
        yield


def _pick(i1, a):
    """a[i] for a 1-element index tensor i1 (no host read)."""
    return a.index_select(0, i1)[0]


def sqp_solve(dynamics, stage_cost, final_cost, node_data, final_data,
              x0, X_init, W_init, settings: SqpSettings = SqpSettings(),
              stage_quad=None, final_quad=None,
              cost_and_dynamics=None, stage_linearize=None) -> SqpSolution:
    """Minimize sum_k l_k(x_k, w_k) + lf(x_N) s.t. x_{k+1} = f_k(x_k, w_k),
    x_0 = x0, from the (possibly infeasible) iterate (X_init, W_init).

    The closures take one node: dynamics(kd, x, w), stage_cost(kd, x, w),
    final_cost(fd, x), with kd a tuple of per-node tensors (node_data
    holds them with a leading N axis). stage_linearize(kd, x, w) -> (A, B,
    l, lx, lw, lxx, lww, lwx) is the fused path; without it, A and B come
    from jacfwd of the dynamics and the rest from stage_quad."""
    N, nw = W_init.shape
    nx = x0.shape[0]
    reg = settings.reg
    nu = settings.merit_nu
    dtype, dev = X_init.dtype, X_init.device
    alphas = _alphas(settings.alphas, X_init)
    nodes_in = (0,) * len(node_data)

    if stage_quad is None:
        from torch.func import grad

        from ..models._fwd import jacfwd

        def stage_quad(kd, x, w):
            def lfun(zz):
                return stage_cost(kd, zz[:nx], zz[nx:])
            z = torch.cat([x, w])
            lz = grad(lfun)(z)
            lzz = jacfwd(grad(lfun))(z)
            return (lfun(z), lz[:nx], lz[nx:], lzz[:nx, :nx], lzz[nx:, nx:],
                    lzz[nx:, :nx])

    if final_quad is None:
        from torch.func import grad

        from ..models._fwd import jacfwd

        def final_quad(fd, x):
            def lfun(xx):
                return final_cost(fd, xx)
            return lfun(x), grad(lfun)(x), jacfwd(grad(lfun))(x)

    if cost_and_dynamics is None:
        def cost_and_dynamics(kd, x, w):
            return stage_cost(kd, x, w), dynamics(kd, x, w)

    node_merit = vmap(vmap(cost_and_dynamics, in_dims=(nodes_in, 0, 0)),
                      in_dims=(None, 0, 0))
    final_batch = vmap(final_cost, in_dims=(None, 0))

    def merit(X, W):
        """(merit, cost, defects) of a batch of iterates X (C, N+1, nx),
        W (C, N, nw): all candidates and nodes in one vmapped call."""
        costs, f = node_merit(node_data, X[:, :-1], W)
        d = f - X[:, 1:]
        total = costs.sum(-1) + final_batch(final_data, X[:, -1])
        return total + nu * d.abs().sum((-1, -2)), total, d

    if stage_linearize is not None:
        def node(kd, x, w):
            A, B, _, lx, lw, lxx, lww, lwx = stage_linearize(kd, x, w)
            return A, B, lx, lw, lxx, lww, lwx
    else:
        from ..models._fwd import jacfwd

        def node(kd, x, w):
            AB = jacfwd(lambda z: dynamics(kd, z[:nx], z[nx:]))(
                torch.cat([x, w]))
            _, lx, lw, lxx, lww, lwx = stage_quad(kd, x, w)
            return AB[:, :nx], AB[:, nx:], lx, lw, lxx, lww, lwx
    linearize_nodes = vmap(node, in_dims=(nodes_in, 0, 0))

    if settings.unrolled_ops:
        from ..models.smallmat import (mm_unrolled as mm,
                                       mtm_unrolled as mtm,
                                       mtv_unrolled as mtv,
                                       mv_unrolled as mv,
                                       spd_solve_unrolled as spd_solve)
    else:
        def mm(X, Y):
            return X @ Y

        def mtm(X, Y):
            return X.transpose(-1, -2) @ Y

        def mv(X, v):
            return (X @ v[..., None])[..., 0]

        def mtv(X, v):
            return (X.transpose(-1, -2) @ v[..., None])[..., 0]

        def spd_solve(A, B):
            return torch.linalg.solve_ex(A, B)[0]    # no error check: no sync
    eye_reg = reg * torch.eye(nw, dtype=dtype, device=dev)

    def serial_backward(A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN):
        Vx, Vxx = VxN, VxxN
        kffs, Kfbs = [None] * N, [None] * N
        for k in reversed(range(N)):
            Ak, Bk = A[k], B[k]
            # affine (defect) term: value gradient evaluated at x' + d
            Vxd = Vx + mv(Vxx, d[k])
            Qx = lx[k] + mtv(Ak, Vxd)
            Qu = lu[k] + mtv(Bk, Vxd)
            VA = mm(Vxx, Ak)
            Qxx = lxx[k] + mtm(Ak, VA)
            Quu = luu[k] + mtm(Bk, mm(Vxx, Bk))
            Qux = lux[k] + mtm(Bk, VA)
            Quu_reg = 0.5 * (Quu + Quu.transpose(-1, -2)) + eye_reg
            kK = spd_solve(Quu_reg, torch.cat([Qu[:, None], Qux], dim=-1))
            kff, Kfb = -kK[:, 0], -kK[:, 1:]
            Vx = Qx + mtv(Kfb, mv(Quu, kff)) + mtv(Kfb, Qu) + mtv(Qux, kff)
            KQux = mtm(Kfb, Qux)
            Vxx = Qxx + mtm(Kfb, mm(Quu, Kfb)) + KQux + KQux.transpose(-1, -2)
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
            kffs[k], Kfbs[k] = kff, Kfb
        return torch.stack(kffs), torch.stack(Kfbs)

    def serial_forward(X, W, A, B, d, kffs, Kfbs):
        """All candidates at once: dx (C, nx) per node."""
        a = alphas[:, None]
        dx = torch.zeros(alphas.shape[0], nx, dtype=dtype, device=dev)
        dXs, dWs = [], []
        for k in range(N):
            dw = a * kffs[k] + mv(Kfbs[k], dx)
            dXs.append(dx)
            dWs.append(dw)
            dx = mv(A[k], dx) + mv(B[k], dw) + a * d[k]
        dXs.append(dx)
        return X + torch.stack(dXs, dim=1), W + torch.stack(dWs, dim=1)

    if settings.parallel_riccati:
        from .pariccati import parallel_backward, parallel_linear_forward

        def backward(A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN):
            return parallel_backward(A, B, lx, lu, lxx, luu, lux, d, VxN,
                                     VxxN, reg)

        # one prefix scan per step-length candidate, vmapped over them
        candidates = vmap(parallel_linear_forward,
                          in_dims=(None,) * 7 + (0,))

        def linear_forward(X, W, A, B, d, kffs, Kfbs):
            return candidates(X, W, A, B, d, kffs, Kfbs, alphas)
    else:
        backward, linear_forward = serial_backward, serial_forward

    g_max, g_min = settings.g_max, settings.g_min
    X = torch.cat([x0[None].to(dtype), X_init[1:]])
    W = W_init
    _, c0, d0 = merit(X[None], W[None])
    cost, d = c0[0], d0[0]
    vio = d.abs().sum()
    alpha_used = Kfbs = None
    for _ in range(settings.num_iterations):
        with _stage("sqp.linearize"):
            A, B, lx, lu, lxx, luu, lux = linearize_nodes(node_data, X[:-1],
                                                          W)
            _, VxN, VxxN = final_quad(final_data, X[-1])
            VxxN = 0.5 * (VxxN + VxxN.T)
        with _stage("sqp.riccati"):
            kffs, Kfbs = backward(A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN)
        with _stage("sqp.line_search"):
            Xc, Wc = linear_forward(X, W, A, B, d, kffs, Kfbs)
            _, cc, dc = merit(Xc, Wc)
        segment(None)       # the acceptance: glue
        vc = dc.abs().sum((-1, -2))
        finite = torch.isfinite(cc) & torch.isfinite(vc)
        inf = torch.full_like(cc, float("inf"))
        cc = torch.where(finite, cc, inf)
        vc = torch.where(finite, vc, inf)
        # filter acceptance (OCS2 SQP semantics): above g_max a step must
        # cut the violation; within it, it must cut the cost and keep the
        # violation inside the g_max corridor
        feasible = vio <= g_max
        acc_inf = vc < (1.0 - 1e-4) * vio
        acc_fea = (cc < cost) & (vc <= torch.clamp(vio + g_min, min=g_max))
        accept = torch.where(feasible, acc_fea, acc_inf) & finite
        score = torch.where(accept, torch.where(feasible, cc, vc), inf)
        best = torch.argmin(score).reshape(1)
        improved = _pick(best, accept)
        X = torch.where(improved, _pick(best, Xc), X)
        W = torch.where(improved, _pick(best, Wc), W)
        d = torch.where(improved, _pick(best, dc), d)
        cost = torch.where(improved, _pick(best, cc), cost)
        vio = torch.where(improved, _pick(best, vc), vio)
        alpha_used = torch.where(improved, _pick(best, alphas),
                                 torch.zeros_like(cost))
    return SqpSolution(X=X, W=W, cost=cost, defect=d.abs().max(), K=Kfbs,
                       alpha=alpha_used)
