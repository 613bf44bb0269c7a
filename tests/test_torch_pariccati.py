"""PyTorch port vs JAX reference: the associative-scan Riccati
(solver/pariccati.py) and SqpSettings(parallel_riccati=True).

The same numpy LQ data (tests/test_pariccati.py's draws and sizes) go
through JAX's parallel_backward / parallel_linear_forward and the port's.
Tolerances:
  * associative_scan against jax.lax.associative_scan with a
    NON-associative integer combine (2a + b): equal results mean the same
    tree of combinations, element for element (exact);
  * gains against the serial sweep at tests/test_pariccati.py's bounds
    (2e-3 (1 + |k|) at N = 12; 5e-3 relative at N = 67), and against
    JAX's parallel gains within 1e-4 (1 + |k|) (measured ~1e-6: the same
    combinations, another LU);
  * the prefix-scan forward pass against the serial recursion and
    against JAX's at test_pariccati.py's 1e-4 (1 + |X|);
  * under torch.func.vmap (B = 3 draws at N = 67, the batch path's use)
    against per-draw calls within 1e-5 (1 + |k|);
  * the MPC solve with parallel_riccati=True (tests/test_pariccati.py's
    full-solve case: horizon 0.3 s / 0.03 s, 2 SQP iterations, LU
    products) against the port's serial solve at that test's bounds
    (W 5e-3 of 1 + |W|, cost 1e-2 relative), against JAX's parallel solve
    at tests/test_torch_mpc.py's bounds (cost 1e-3 relative, X 2e-3,
    W 0.5 N, the same alpha), and one batched step of
    make_batched_mpc_step (B = 2) against the unbatched solves at
    tests/test_torch_parallel.py's bounds (X 1e-5, W 1e-3 N, cost 2e-4
    relative, the same alpha).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_control_tpu.solver import pariccati as JP
from test_pariccati import _random_lq

from qm_control_tpu_torch.solver import pariccati as TP
from qm_control_tpu_torch.solver.sqp import SqpSettings

torch.set_num_threads(1)


def _t(args):
    return [torch.tensor(np.asarray(a), dtype=torch.float32) for a in args]


def _serial_backward(A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN, reg):
    """The serial defect-aware sweep of solver/sqp.py in plain products
    (tests/test_pariccati.py:_serial_backward), in torch."""
    nw = B.shape[-1]
    Vx, Vxx = VxN, VxxN
    ks, Ks = [], []
    for k in reversed(range(A.shape[0])):
        Vxd = Vx + Vxx @ d[k]
        Qx = lx[k] + A[k].T @ Vxd
        Qu = lu[k] + B[k].T @ Vxd
        VA = Vxx @ A[k]
        Qxx = lxx[k] + A[k].T @ VA
        Quu = luu[k] + B[k].T @ (Vxx @ B[k])
        Qux = lux[k] + B[k].T @ VA
        Quu_reg = 0.5 * (Quu + Quu.T) + reg * torch.eye(nw)
        kK = torch.linalg.solve(Quu_reg, torch.cat([Qu[:, None], Qux], 1))
        kff, Kfb = -kK[:, 0], -kK[:, 1:]
        Vx = Qx + Kfb.T @ (Quu @ kff) + Kfb.T @ Qu + Qux.T @ kff
        KQux = Kfb.T @ Qux
        Vxx = Qxx + Kfb.T @ (Quu @ Kfb) + KQux + KQux.T
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks.append(kff)
        Ks.append(Kfb)
    return torch.stack(ks[::-1]), torch.stack(Ks[::-1])


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_combines_as_jax(reverse):
    for n in (*range(1, 10), 16, 17, 67):
        a = np.arange(1, n + 1, dtype=np.int32)
        b = (np.arange(n, dtype=np.int32) % 3) - 1
        jout = jax.lax.associative_scan(
            lambda x, y: (2 * x[0] + y[0], x[1] - 3 * y[1]),
            (jnp.asarray(a), jnp.asarray(b)), reverse=reverse)
        tout = TP.associative_scan(
            lambda x, y: (2 * x[0] + y[0], x[1] - 3 * y[1]),
            (torch.from_numpy(a), torch.from_numpy(b)), reverse=reverse)
        for j, t in zip(jout, tout):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("N,nx,nw,scale,seed,bound", [
    (12, 5, 3, 0.3, 0, 2e-3), (67, 6, 4, 0.15, 1, 5e-3)])
def test_parallel_backward_matches_serial_and_jax(N, nx, nw, scale, seed,
                                                  bound):
    args = [np.asarray(a) for a in _random_lq(np.random.default_rng(seed),
                                              N=N, nx=nx, nw=nw,
                                              scale=scale)]
    reg = 1e-6
    k_p, K_p = TP.parallel_backward(*_t(args), reg)
    k_s, K_s = _serial_backward(*_t(args), reg)
    k_j, K_j = (np.asarray(a) for a in jax.jit(JP.parallel_backward)(
        *map(jnp.asarray, args), reg))
    for p, s, j in ((k_p, k_s, k_j), (K_p, K_s, K_j)):
        p, s = p.numpy(), s.numpy()
        assert np.abs(p - s).max() < bound * (1 + np.abs(s).max())
        assert np.abs(p - j).max() < 1e-4 * (1 + np.abs(j).max())


def test_parallel_forward_matches_serial_and_jax():
    rng = np.random.default_rng(2)
    N, nx, nw = 15, 5, 3
    A, B, _, _, _, _, _, d, _, _ = [np.asarray(a)
                                    for a in _random_lq(rng, N, nx, nw)]
    kffs = rng.standard_normal((N, nw)).astype(np.float32)
    Kfbs = (0.2 * rng.standard_normal((N, nw, nx))).astype(np.float32)
    X = rng.standard_normal((N + 1, nx)).astype(np.float32)
    W = rng.standard_normal((N, nw)).astype(np.float32)
    alpha = 0.7
    tA, tB, td, tk, tK, tX, tW = _t((A, B, d, kffs, Kfbs, X, W))
    dx, dX, dW = torch.zeros(nx), [], []
    for k in range(N):
        dw = alpha * tk[k] + tK[k] @ dx
        dX.append(dx)
        dW.append(dw)
        dx = tA[k] @ dx + tB[k] @ dw + alpha * td[k]
    X_s = (tX + torch.stack(dX + [dx])).numpy()
    W_s = (tW + torch.stack(dW)).numpy()
    X_p, W_p = TP.parallel_linear_forward(tX, tW, tA, tB, td, tk, tK, alpha)
    X_j, W_j = JP.parallel_linear_forward(*map(jnp.asarray, (
        X, W, A, B, d, kffs, Kfbs)), alpha)
    for p, s, j in ((X_p, X_s, X_j), (W_p, W_s, W_j)):
        assert np.abs(p.numpy() - s).max() < 1e-4 * (1 + np.abs(s).max())
        assert np.abs(p.numpy() - np.asarray(j)).max() < 1e-4 * (
            1 + np.abs(s).max())


def test_parallel_backward_under_vmap():
    draws = [[np.asarray(a) for a in _random_lq(
        np.random.default_rng(10 + i), N=67, nx=6, nw=4, scale=0.15)]
        for i in range(3)]
    batched = [torch.from_numpy(np.stack(a).astype(np.float32))
               for a in zip(*draws)]
    kb, Kb = vmap(lambda *a: TP.parallel_backward(*a, 1e-6))(*batched)
    for i, args in enumerate(draws):
        k, K = TP.parallel_backward(*_t(args), 1e-6)
        for b, one in ((kb[i], k), (Kb[i], K)):
            assert (b - one).abs().max() <= 1e-5 * (1 + one.abs().max())


@pytest.fixture(scope="module")
def problem():
    """tests/test_pariccati.py:test_full_mpc_solve_parallel_vs_serial's
    problem in both packages."""
    from qm_control_tpu.config import MpcConfig, QmConfig
    from qm_control_tpu.experiments import _standing_setup
    from qm_control_tpu.models import centroidal as JC
    from qm_control_tpu.mpc.mpc import mpc_step as jmpc_step
    from qm_control_tpu.ocp.problem import make_ocp as jmake_ocp
    from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu.runtime.estimator import (observation_from_rbd,
                                                  rbd_state_from_plant)
    from qm_control_tpu.runtime.plant import init_plant_state
    from qm_control_tpu.solver.sqp import SqpSettings as JSettings

    from qm_control_tpu_torch import config as TCfg
    from qm_control_tpu_torch.interop import (mode_schedule_from_numpy,
                                              target_from_numpy)
    from qm_control_tpu_torch.models import centroidal as TC
    from qm_control_tpu_torch.models import load_model
    from qm_control_tpu_torch.ocp.problem import make_ocp

    cfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.3, dt=0.03,
                                         num_iterations=2))
    model, info, q0, s = _standing_setup(cfg)
    target = target_from_knots([0.0, 5.0], [s, s])
    ms = GaitSchedule(GAIT_LIBRARY["trot"]).mode_schedule(0.0, 5.0)
    plant = init_plant_state(q0, model=model)
    x0 = np.asarray(observation_from_rbd(
        model, info, rbd_state_from_plant(model, plant.q, plant.v)))
    N = cfg.mpc.num_nodes
    w0 = np.asarray(JC.weight_compensating_input(info, jnp.ones(4)),
                    np.float32)
    W = np.tile(w0[None], (N, 1))
    X = np.tile(x0[None].astype(np.float32), (N + 1, 1))
    jocp = jmake_ocp(model, info, cfg)
    jsol = jax.jit(lambda: jmpc_step(
        jocp, model, info, cfg, JSettings(num_iterations=2,
                                          unrolled_ops=False,
                                          parallel_riccati=True),
        jnp.asarray(0.0), jnp.asarray(x0), target, ms, jnp.asarray(W),
        jnp.asarray(X), jnp.asarray(0.0), jnp.asarray(False)))()

    tm = load_model()
    ti = TC.make_centroidal_info(tm)
    tcfg = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=0.3, dt=0.03, num_iterations=2))
    tt = target_from_numpy(np.asarray(target.times),
                           np.asarray(target.states), device="cpu")
    tms = mode_schedule_from_numpy(np.asarray(ms.event_times),
                                   np.asarray(ms.modes), device="cpu")
    args = (torch.zeros(()), torch.from_numpy(x0), tt, tms,
            torch.from_numpy(W), torch.from_numpy(X), torch.zeros(()),
            torch.tensor(False))
    return jsol, (make_ocp(tm, ti, tcfg), tm, ti, tcfg), args


def test_mpc_solve_parallel_riccati_matches_serial_and_jax(problem):
    from qm_control_tpu_torch.mpc.mpc import mpc_step
    jsol, (ocp, tm, ti, tcfg), args = problem
    pols = {par: mpc_step(ocp, tm, ti, tcfg, SqpSettings(
        num_iterations=2, unrolled_ops=False, parallel_riccati=par), *args)
        for par in (False, True)}
    Ws, Wp = pols[False].W.numpy(), pols[True].W.numpy()
    assert np.abs(Ws - Wp).max() / (1 + np.abs(Ws).max()) < 5e-3
    cs, cp = float(pols[False].cost), float(pols[True].cost)
    assert abs(cs - cp) < 1e-2 * (1 + abs(cs))
    p, jc = pols[True], float(jsol.cost)
    assert float(p.alpha) == float(jsol.alpha)
    assert abs(float(p.cost) - jc) <= 1e-3 * max(1.0, abs(jc))
    np.testing.assert_allclose(p.X.numpy(), np.asarray(jsol.X), atol=2e-3)
    np.testing.assert_allclose(p.W.numpy(), np.asarray(jsol.W), atol=0.5)


def test_batched_mpc_step_with_parallel_riccati(problem):
    """The batch path vmaps mpc_step, and with it the scan: B = 2 (the
    problem and its state shifted 1 cm up) against unbatched solves."""
    from qm_control_tpu_torch.mpc.mpc import mpc_step
    from qm_control_tpu_torch.parallel import (BatchScenario,
                                               make_batched_mpc_step)
    _, (ocp, tm, ti, tcfg), (t, x, tt, tms, W, X, _, _) = problem
    settings = SqpSettings(num_iterations=1, parallel_riccati=True)
    xs = torch.stack([x, x])
    xs[1, 8] += 0.01

    def tile(a):
        return torch.stack([a, a])
    batch = BatchScenario(t=tile(t), x=xs,
                          target=type(tt)(*map(tile, tt)),
                          ms=type(tms)(*map(tile, tms)), W_warm=tile(W),
                          X_warm=tile(X))
    _, pol = make_batched_mpc_step(tm, ti, tcfg, settings)(batch)
    for i in range(2):
        one = mpc_step(ocp, tm, ti, tcfg, settings, t, xs[i], tt, tms, W, X,
                       torch.tensor(1.0 / tcfg.mpc.mpc_frequency),
                       torch.tensor(False))
        assert float(pol.alpha[i]) == float(one.alpha)
        c = float(one.cost)
        assert abs(float(pol.cost[i]) - c) <= 2e-4 * max(1.0, abs(c))
        assert (pol.X[i] - one.X).abs().max() <= 1e-5
        assert (pol.W[i] - one.W).abs().max() <= 1e-3
