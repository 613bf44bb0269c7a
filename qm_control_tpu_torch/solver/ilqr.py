"""Generic iLQR / SLQ solver (port of qm_control_tpu/solver/ilqr.py):
single-shooting rollout, linearization vmapped over the nodes, Riccati
backward sweep, and a line search that rolls every step length out at
once (torch.func.vmap over the candidates) and takes the best.

The solver is problem-agnostic: it sees dynamics/cost closures over
(k_data, x, w), k_data one node's slice of the per-node data (a tensor or
a tuple of tensors with a leading N axis). Python loops stand in for the
JAX package's lax.scan; nothing is read back to the host. No path of the
package calls it: the MPC uses the multiple-shooting solver.sqp.
"""
from functools import partial
from typing import NamedTuple

import torch
from torch.func import grad, jacfwd, vmap
from torch.utils._pytree import tree_map

from .sqp import _pick


class IlqrSettings(NamedTuple):
    num_iterations: int = 1          # task.info sqp.sqpIteration
    reg: float = 1e-5                # hessianCorrectionMultiple (shift)
    # line-search step lengths (maxStepLength 1.0, minStepLength 1e-2)
    alphas: tuple = (1.0, 0.6, 0.35, 0.2, 0.1, 0.05, 0.01)


class IlqrSolution(NamedTuple):
    X: torch.Tensor          # (N+1, nx) optimized state trajectory
    W: torch.Tensor          # (N, nw) optimized (reduced) inputs
    cost: torch.Tensor       # scalar, final total cost
    K: torch.Tensor          # (N, nw, nx) feedback gains of the last sweep
    alpha: torch.Tensor      # accepted step length of the last iteration


def ilqr_solve(dynamics, stage_cost, final_cost, node_data, final_data,
               x0, W_init, settings: IlqrSettings = IlqrSettings(),
               stage_quad=None, final_quad=None) -> IlqrSolution:
    """Minimize sum_k stage_cost(node_k, x_k, w_k) + final_cost(final, x_N)
    with x_{k+1} = dynamics(node_k, x_k, w_k), from x0 and W_init (N, nw).

    stage_quad(k_data, x, w) -> (l, lx, lw, lxx, lww, lwx) and
    final_quad(final_data, x) -> (l, lx, lxx) optionally supply the cost
    quadratization (default: autodiff gradient and Hessian)."""
    N, nw = W_init.shape
    nx = x0.shape[0]
    reg = settings.reg
    f = dict(dtype=x0.dtype, device=x0.device)

    def node_k(k):
        return tree_map(lambda a: a[k], node_data)

    if stage_quad is None:
        def stage_quad(kd, x, w):
            def lfun(zz):
                return stage_cost(kd, zz[:nx], zz[nx:])
            z = torch.cat([x, w])
            lz = grad(lfun)(z)
            lzz = jacfwd(grad(lfun))(z)
            return (lfun(z), lz[:nx], lz[nx:], lzz[:nx, :nx], lzz[nx:, nx:],
                    lzz[nx:, :nx])

    if final_quad is None:
        def final_quad(fd, x):
            def lfun(xx):
                return final_cost(fd, xx)
            return lfun(x), grad(lfun)(x), jacfwd(grad(lfun))(x)

    def rollout(W):
        x, X, costs = x0, [], []
        for k in range(N):
            kd = node_k(k)
            X.append(x)
            costs.append(stage_cost(kd, x, W[k]))
            x = dynamics(kd, x, W[k])
        X.append(x)
        return torch.stack(X), torch.stack(costs).sum() + final_cost(
            final_data, x)

    def node(kd, x, w):
        A = jacfwd(lambda xx: dynamics(kd, xx, w))(x)
        B = jacfwd(lambda ww: dynamics(kd, x, ww))(w)
        _, lx, lw, lxx, lww, lwx = stage_quad(kd, x, w)
        # forward mode gives a 0-d tensor times a Python float a float64
        # tangent: the derivatives come back in x0's dtype, as in JAX
        return tuple(a.to(x0.dtype) for a in (A, B, lx, lw, lxx, lww, lwx))
    linearize = vmap(node)

    def backward(A, B, lx, lu, lxx, luu, lux, Vx, Vxx):
        eye_w = torch.eye(nw, **f)
        kffs, Kfbs = [None] * N, [None] * N
        for k in reversed(range(N)):
            Ak, Bk = A[k], B[k]
            Qx = lx[k] + Ak.T @ Vx
            Qu = lu[k] + Bk.T @ Vx
            VA = Vxx @ Ak
            Qxx = lxx[k] + Ak.T @ VA
            Quu = luu[k] + Bk.T @ (Vxx @ Bk)
            Qux = lux[k] + Bk.T @ VA
            Quu_reg = 0.5 * (Quu + Quu.T) + reg * eye_w
            kK = torch.linalg.solve_ex(
                Quu_reg, torch.cat([Qu[:, None], Qux], dim=1))[0]
            kff, Kfb = -kK[:, 0], -kK[:, 1:]
            Vx = Qx + Kfb.T @ (Quu @ kff) + Kfb.T @ Qu + Qux.T @ kff
            Vxx = Qxx + Kfb.T @ Quu @ Kfb + Kfb.T @ Qux + Qux.T @ Kfb
            Vxx = 0.5 * (Vxx + Vxx.T)
            kffs[k], Kfbs[k] = kff, Kfb
        return torch.stack(kffs), torch.stack(Kfbs)

    def closed_loop(X_ref, W_ref, kffs, Kfbs, alpha):
        x, X, W, costs = x0, [], [], []
        for k in range(N):
            kd = node_k(k)
            w = W_ref[k] + alpha * kffs[k] + Kfbs[k] @ (x - X_ref[k])
            X.append(x)
            W.append(w)
            costs.append(stage_cost(kd, x, w))
            x = dynamics(kd, x, w)
        X.append(x)
        return (torch.stack(X), torch.stack(W),
                torch.stack(costs).sum() + final_cost(final_data, x))

    X, cost = rollout(W_init)
    W = W_init
    alphas = torch.tensor(settings.alphas, **f)
    Kfbs = alpha_used = None
    for _ in range(settings.num_iterations):
        A, B, lx, lu, lxx, luu, lux = linearize(node_data, X[:-1], W)
        # terminal value from the final cost quadratization
        _, VxN, VxxN = final_quad(final_data, X[-1])
        VxN, VxxN = VxN.to(x0.dtype), VxxN.to(x0.dtype)
        VxxN = 0.5 * (VxxN + VxxN.T)
        kffs, Kfbs = backward(A, B, lx, lu, lxx, luu, lux, VxN, VxxN)
        Xc, Wc, costs = vmap(partial(closed_loop, X, W, kffs, Kfbs))(alphas)
        # a candidate with a non-finite cost never wins
        costs = torch.where(torch.isfinite(costs), costs,
                            torch.full_like(costs, float("inf")))
        best = torch.argmin(costs).reshape(1)
        improved = _pick(best, costs) < cost
        X = torch.where(improved, _pick(best, Xc), X)
        W = torch.where(improved, _pick(best, Wc), W)
        cost = torch.minimum(_pick(best, costs), cost)
        alpha_used = torch.where(improved, _pick(best, alphas),
                                 torch.zeros_like(cost))
    return IlqrSolution(X=X, W=W, cost=cost, K=Kfbs, alpha=alpha_used)
