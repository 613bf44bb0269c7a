"""PyTorch port vs JAX reference: the iLQR solver (solver/ilqr.py) on
tests/test_ilqr.py's three cases, at that file's bounds, and against the
JAX solver on the same inputs: cost within 1e-4 relative, W and X within
1e-3 (1 + |W|inf) (measured ~1e-6 on the LQR, ~1e-5 on the pendulum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.solver.ilqr import IlqrSettings as JSettings
from qm_control_tpu.solver.ilqr import ilqr_solve as j_ilqr
from test_ilqr import _lqr_reference

from qm_control_tpu_torch.solver import IlqrSettings, ilqr_solve

torch.set_num_threads(1)


def _close(sol, jsol):
    jc = float(jsol.cost)
    assert abs(float(sol.cost) - jc) <= 1e-4 * max(1.0, abs(jc))
    for a, b in ((sol.W, jsol.W), (sol.X, jsol.X)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-3 * (1 + np.abs(b).max())
    assert float(sol.alpha) == float(jsol.alpha)


def test_lqr_exact_in_one_iteration():
    N, dt = 30, 0.1
    A = np.array([[1.0, dt], [0.0, 1.0]], np.float32)
    B = np.array([[0.5 * dt * dt], [dt]], np.float32)
    Q = np.diag([1.0, 0.1]).astype(np.float32)
    R = np.array([[0.01]], np.float32)
    settings = dict(num_iterations=1, reg=1e-9, alphas=(1.0,))

    def problem(xp, cast):
        A_, B_, Q_, R_ = map(cast, (A, B, Q, R))
        return (lambda kd, x, w: A_ @ x + B_ @ w,
                lambda kd, x, w: 0.5 * x @ Q_ @ x + 0.5 * w @ R_ @ w,
                lambda fd, x: 5.0 * (x @ x))
    sol = ilqr_solve(*problem(torch, torch.from_numpy), torch.zeros(N), 0.0,
                     torch.tensor([1.0, 0.0]), torch.zeros(N, 1),
                     IlqrSettings(**settings))
    jsol = j_ilqr(*problem(jnp, jnp.asarray), jnp.zeros(N), 0.0,
                  jnp.array([1.0, 0.0]), jnp.zeros((N, 1)),
                  JSettings(**settings))
    Ks, _ = _lqr_reference(A, B, Q, R, 10.0 * np.eye(2), N)
    x = np.array([1.0, 0.0])
    X_ref, W_ref = [x], []
    for k in range(N):
        u = -Ks[k] @ x
        W_ref.append(u)
        x = A @ x + B @ u
        X_ref.append(x)
    np.testing.assert_allclose(sol.W.numpy(), np.array(W_ref), atol=1e-3)
    np.testing.assert_allclose(sol.X.numpy(), np.array(X_ref), atol=1e-3)
    _close(sol, jsol)


def _pendulum(xp):
    N, dt = 40, 0.05
    sin = torch.sin if xp is torch else jnp.sin

    def dyn(kd, x, w):
        th, om = x[0], x[1]
        return xp.stack([th + dt * om, om + dt * (-9.81 * sin(th) + w[0])])
    return (dyn, lambda kd, x, w: 0.5 * (x @ x) + 0.01 * (w @ w),
            lambda fd, x: 10.0 * (x @ x))


@pytest.mark.parametrize("iters", [1, 3])
def test_nonlinear_improvement_matches_jax(iters):
    """tests/test_ilqr.py's pendulum: the cost falls with iterations in
    the port as in JAX, on the same iterates."""
    N = 40
    dyn, cost, final = _pendulum(torch)
    x0, W0 = torch.tensor([2.5, 0.0]), torch.zeros(N, 1)
    x, c = x0, 0.0
    for k in range(N):
        c += float(cost(None, x, W0[k]))
        x = dyn(None, x, W0[k])
    c += float(final(None, x))
    sol = ilqr_solve(dyn, cost, final, torch.zeros(N), 0.0, x0, W0,
                     IlqrSettings(num_iterations=iters))
    assert float(sol.cost) < 0.9 * c
    if iters > 1:
        one = ilqr_solve(dyn, cost, final, torch.zeros(N), 0.0, x0, W0,
                         IlqrSettings(num_iterations=1))
        assert float(sol.cost) <= float(one.cost) + 1e-6
    jsol = j_ilqr(*_pendulum(jnp), jnp.zeros(N), 0.0, jnp.array([2.5, 0.0]),
                  jnp.zeros((N, 1)), JSettings(num_iterations=iters))
    _close(sol, jsol)


def test_line_search_rejects_divergent_step():
    """A pathological initialization must not make the cost worse."""
    N, dt = 20, 0.1

    def problem(xp):
        return (lambda kd, x, w: x + dt * xp.stack([x[1], w[0] - x[0] ** 3]),
                lambda kd, x, w: 0.5 * (x @ x) + 0.5 * (w @ w),
                lambda fd, x: x @ x)
    dyn, cost, final = problem(torch)
    x0, W0 = torch.tensor([3.0, -1.0]), 50.0 * torch.ones(N, 1)
    x, c = x0, 0.0
    for k in range(N):
        c += float(cost(None, x, W0[k]))
        x = dyn(None, x, W0[k])
    c += float(final(None, x))
    sol = ilqr_solve(dyn, cost, final, torch.zeros(N), 0.0, x0, W0,
                     IlqrSettings(num_iterations=2))
    assert float(sol.cost) <= c + 1e-3
    assert np.isfinite(float(sol.cost))
    jsol = j_ilqr(*problem(jnp), jnp.zeros(N), 0.0, jnp.array([3.0, -1.0]),
                  50.0 * jnp.ones((N, 1)), JSettings(num_iterations=2))
    _close(sol, jsol)
