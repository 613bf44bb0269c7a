"""PyTorch port vs JAX reference: the Riccati helpers, the warm-start
shift, the multiple-shooting SQP through mpc_step, and the golden
standing solution.

The solves run at tests/test_mpc.py's small horizon (0.24 s / 0.04 s,
N = 6) from the same numpy inputs in both packages, cold and then warm,
on the stance and the trot schedules. Tolerances: the same accepted step
alpha; cost within 1e-3 relative; X within 2e-3; W within 0.5 (forces in
N). The port's MpcSolver on the CPU is held to tests/golden_standing.json
at tests/test_golden.py's bounds (cost 1e-3 relative, x_mid 2e-3, forces
0.5 N) and to its physical invariants.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.config import MpcConfig, QmConfig
from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as jload
from qm_control_tpu.models import smallmat as JSM
from qm_control_tpu.models.spec import default_q
from qm_control_tpu.mpc.mpc import MpcSolver as JMpcSolver
from qm_control_tpu.mpc.mpc import shift_warm_start as jshift
from qm_control_tpu.ocp.reference import target_from_knots
from qm_control_tpu_torch import config as TCfg
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY as TGAITS
from qm_control_tpu_torch.gaits.library import GaitSchedule as TGaitSchedule
from qm_control_tpu_torch.interop import (mode_schedule_from_numpy,
                                          target_from_numpy)
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as tload
from qm_control_tpu_torch.models import smallmat as TSM
from qm_control_tpu_torch.mpc.mpc import MpcSolver, mpc_step, shift_warm_start
from qm_control_tpu_torch.ocp.problem import make_ocp
from qm_control_tpu_torch.ocp.reference import \
    target_from_knots as ttarget_from_knots
from qm_control_tpu_torch.solver.sqp import SqpSettings

torch.set_num_threads(1)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_standing.json")


# ------------------------------------------------------- Riccati helpers ---

@pytest.mark.parametrize("n,m", [(30, 31), (6, 1)])
def test_spd_solve_unrolled_matches_jax(n, m):
    rng = np.random.default_rng(n)
    M = rng.normal(size=(4, n, n)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n, dtype=np.float32)
    B = rng.normal(size=(4, n, m)).astype(np.float32)
    ref = np.asarray(JSM.spd_solve_unrolled(jnp.asarray(A), jnp.asarray(B)))
    out = TSM.spd_solve_unrolled(torch.tensor(A), torch.tensor(B)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-4 * scale
    np.testing.assert_allclose(
        TSM.cholesky_unrolled(torch.tensor(A)).numpy(),
        np.asarray(JSM.cholesky_unrolled(jnp.asarray(A))), rtol=1e-4,
        atol=1e-4 * np.sqrt(np.abs(A).max()))


def test_cholesky_unrolled_clamps_like_jax():
    """A semidefinite matrix: the clamped pivot (sqrt(1e-12)) and zero
    entries above the diagonal, as in the JAX module."""
    v = np.array([[1.0, 2.0, 0.0]], np.float32)
    A = v.T @ v
    ref = np.asarray(JSM.cholesky_unrolled(jnp.asarray(A)))
    out = TSM.cholesky_unrolled(torch.tensor(A)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-9)
    assert np.all(np.triu(out, 1) == 0.0)
    assert out[1, 1] == pytest.approx(1e-6)


def test_products_match_matmul():
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.normal(size=(5, 9, 12)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(5, 12, 7)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(5, 12)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(5, 9)), dtype=torch.float32)
    torch.testing.assert_close(TSM.mm_unrolled(A, B), A @ B)
    torch.testing.assert_close(TSM.mv_unrolled(A, v), (A @ v[..., None])[..., 0])
    torch.testing.assert_close(TSM.mtv_unrolled(A, w),
                               (A.transpose(-1, -2) @ w[..., None])[..., 0])
    torch.testing.assert_close(TSM.mtm_unrolled(A, A),
                               A.transpose(-1, -2) @ A)
    np.testing.assert_allclose(
        TSM.mm_unrolled(A, B).numpy(),
        np.asarray(JSM.mm_unrolled(jnp.asarray(A.numpy()),
                                   jnp.asarray(B.numpy()))), atol=1e-5)


@pytest.mark.parametrize("shift", [0.0, 0.010, 0.03, 0.2])
def test_shift_warm_start_matches_jax(shift):
    W = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32)
    ref = np.asarray(jshift(jnp.asarray(W), jnp.float32(shift), 0.015))
    out = shift_warm_start(torch.tensor(W), torch.tensor(shift), 0.015)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    if shift == 0.0:
        np.testing.assert_array_equal(out.numpy(), W)


# ------------------------------------------------------------- the solve ---

def _small_cfg():
    return QmConfig().with_(mpc=MpcConfig(time_horizon=0.24, dt=0.04,
                                          num_iterations=1))


def _tcfg(cfg):
    return TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=cfg.mpc.time_horizon, dt=cfg.mpc.dt,
        num_iterations=cfg.mpc.num_iterations))


def _standing(z=0.4):
    x = np.zeros(30, dtype=np.float32)
    x[6:30] = default_q(base_pos=(0.0, 0.0, z))
    s = np.zeros(37)
    s[:30] = x
    s[8] = 0.4
    s[30:33] = [0.52, 0.09, 0.78]
    s[33:37] = [0.5, -0.5, 0.5, -0.5]
    return x, s


@pytest.fixture(scope="module")
def solvers():
    cfg = _small_cfg()
    jm = jload()
    tm = tload()
    jsolver = JMpcSolver(jm, JC.make_centroidal_info(jm), cfg)
    ti = TC.make_centroidal_info(tm)
    tcfg = _tcfg(cfg)
    return jsolver, tm, ti, tcfg, make_ocp(tm, ti, tcfg)


def _schedule(gait):
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    if gait != "stance":
        gs.insert_template(GAIT_LIBRARY[gait], 0.02)
    ms = gs.mode_schedule(0.0, 2.0)
    return ms, mode_schedule_from_numpy(np.asarray(ms.event_times),
                                        np.asarray(ms.modes), device="cpu")


def _close(jp, tp):
    assert float(tp.alpha) == float(jp.alpha)
    jc = float(jp.cost)
    assert abs(float(tp.cost) - jc) <= 1e-3 * max(1.0, abs(jc)), \
        (float(tp.cost), jc)
    np.testing.assert_allclose(tp.X.numpy(), np.asarray(jp.X), atol=2e-3)
    np.testing.assert_allclose(tp.W.numpy(), np.asarray(jp.W), atol=0.5)
    np.testing.assert_array_equal(tp.modes.numpy(), np.asarray(jp.modes))
    np.testing.assert_allclose(tp.t_nodes.numpy(), np.asarray(jp.t_nodes),
                               atol=1e-6)


@pytest.mark.parametrize("gait", ["stance", "trot"])
def test_mpc_step_cold_then_warm_matches_jax(solvers, gait):
    """mpc_step (and so sqp_solve) cold, then warm-started from its own
    solution 10 ms later at a perturbed state, against the JAX MpcSolver
    on the same inputs."""
    jsolver, tm, ti, tcfg, ocp = solvers
    x0, s = _standing()
    jt = target_from_knots([0.0, 2.0], [s, s])
    tt = target_from_numpy(np.asarray(jt.times), np.asarray(jt.states),
                           device="cpu")
    jms, tms = _schedule(gait)
    settings = SqpSettings(num_iterations=1)
    jsolver.reset()
    N = tcfg.mpc.num_nodes
    z = torch.zeros(())
    jp1 = jsolver.solve(0.0, jnp.asarray(x0), jt, jms)
    tp1 = mpc_step(ocp, tm, ti, tcfg, settings, z, torch.tensor(x0), tt, tms,
                   torch.zeros(N, 30), torch.zeros(N + 1, 30), z,
                   torch.tensor(True))
    _close(jp1, tp1)
    x1 = x0.copy()
    x1[:3] += np.float32([0.02, -0.01, 0.01])
    jp2 = jsolver.solve(0.01, jnp.asarray(x1), jt, jms)
    tp2 = mpc_step(ocp, tm, ti, tcfg, settings, torch.tensor(0.01),
                   torch.tensor(x1), tt, tms, tp1.W, tp1.X,
                   torch.tensor(0.01), torch.tensor(False))
    _close(jp2, tp2)
    assert torch.isfinite(tp2.X).all() and tp2.X.dtype == torch.float32


def test_unrolled_ops_false_agrees(solvers):
    """The LU-solve Riccati path gives the same solution, and so does the
    associative-scan sweep (parallel_riccati=True), at
    tests/test_pariccati.py's bounds (W 5e-3 of 1 + |W|, cost 1e-2
    relative) with the same accepted step."""
    _, tm, ti, tcfg, ocp = solvers
    x0, s = _standing()
    tt = ttarget_from_knots([0.0, 2.0], [s, s], device="cpu")
    _, tms = _schedule("trot")
    N = tcfg.mpc.num_nodes
    z = torch.zeros(())
    out = [mpc_step(ocp, tm, ti, tcfg, st, z,
                    torch.tensor(x0), tt, tms, torch.zeros(N, 30),
                    torch.zeros(N + 1, 30), z, torch.tensor(True))
           for st in (SqpSettings(unrolled_ops=True),
                      SqpSettings(unrolled_ops=False),
                      SqpSettings(parallel_riccati=True))]
    assert float(out[0].alpha) == float(out[1].alpha)
    assert float(out[1].cost) == pytest.approx(float(out[0].cost), rel=1e-4)
    torch.testing.assert_close(out[1].X, out[0].X, atol=1e-4, rtol=0)
    assert float(out[2].alpha) == float(out[0].alpha)
    cs = float(out[0].cost)
    assert abs(float(out[2].cost) - cs) < 1e-2 * (1 + abs(cs))
    assert (out[2].W - out[0].W).abs().max() < 5e-3 * (
        1 + out[0].W.abs().max())


# ----------------------------------------------------------------- golden ---

@pytest.fixture(scope="module")
def golden_solution():
    """tests/test_golden.py's scenario through the port's MpcSolver."""
    cfg = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=0.5, dt=0.025, num_iterations=3))
    x0, s = _standing(0.38)
    tm = tload()
    target = ttarget_from_knots([0.0, 10.0], [s, s], device="cpu")
    ms = TGaitSchedule(TGAITS["stance"]).mode_schedule(0.0, 10.0,
                                                       device="cpu")
    x0[8] = 0.38
    mpc = MpcSolver(tm, TC.make_centroidal_info(tm), cfg, device="cpu")
    return tm, mpc.solve(0.0, torch.tensor(x0), target, ms)


def test_golden_standing_solution(golden_solution):
    _, pol = golden_solution
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    assert abs(float(pol.cost) - golden["cost"]) <= \
        1e-3 * max(1.0, abs(golden["cost"]))
    np.testing.assert_allclose(pol.X[10].numpy(), golden["x_mid"], atol=2e-3)
    np.testing.assert_allclose(pol.U[0].numpy(), golden["u_first"], atol=0.5)
    np.testing.assert_allclose(pol.U[10].numpy(), golden["u_mid"], atol=0.5)


def test_golden_physical_invariants(golden_solution):
    model, pol = golden_solution
    U = pol.U.numpy()
    fz = U[:, 2] + U[:, 5] + U[:, 8] + U[:, 11]
    np.testing.assert_allclose(fz[:-1].mean(), model.total_mass * 9.81,
                               rtol=0.05)
    X = pol.X.numpy()
    assert 0.37 < X[-1, 8] < 0.41
    assert np.abs(U[:, 12:24]).max() < 2.0
    assert (pol.modes.numpy() == 15).all()


def test_device_rule():
    """New entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tm = tload()
    cfg = _tcfg(_small_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MpcSolver(tm, TC.make_centroidal_info(tm), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttarget_from_knots([0.0, 1.0], np.zeros((2, 37)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TGaitSchedule().mode_schedule(0.0, 1.0)
    from qm_control_tpu_torch.experiments import standing_ee_hold
    with pytest.raises(RuntimeError, match="device='cpu'"):
        standing_ee_hold(duration=0.25)


def test_options_not_ported_raise(solvers):
    """The EE-wrench feedthrough of the MPC dynamics, which raised before it
    was ported, now runs: a loop with LoopConfig(mpc_wrench_feedthrough=
    True) builds, mpc_step with a zero wrench equals mpc_step without one
    bit for bit, and with a 25 N lateral wrench it matches the JAX mpc_step
    at the bounds above, cold on the stance schedule."""
    import jax

    from qm_control_tpu.mpc.mpc import mpc_step as jmpc_step
    from qm_control_tpu.ocp.problem import make_ocp as jmake_ocp
    from qm_control_tpu.solver.sqp import SqpSettings as JSqpSettings
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    jsolver, tm, ti, tcfg, ocp = solvers
    ControlLoop(tm, ti, tcfg, LoopConfig(mpc_wrench_feedthrough=True),
                device="cpu")
    x0, s = _standing()
    jt = target_from_knots([0.0, 2.0], [s, s])
    tt = target_from_numpy(np.asarray(jt.times), np.asarray(jt.states),
                           device="cpu")
    jms, tms = _schedule("stance")
    N = tcfg.mpc.num_nodes
    z = torch.zeros(())

    def step(wrench):
        return mpc_step(ocp, tm, ti, tcfg, SqpSettings(), z,
                        torch.tensor(x0), tt, tms, torch.zeros(N, 30),
                        torch.zeros(N + 1, 30), z, torch.tensor(True),
                        ee_wrench=wrench)
    free, zero = step(None), step(torch.zeros(6))
    for a, b in zip(free, zero):
        assert torch.equal(a, b)
    wrench = np.float32([0.0, -25.0, 0.0, 0.0, 0.0, 0.0])
    jocp = jmake_ocp(jsolver.model, jsolver.info, jsolver.cfg)
    jp = jax.jit(lambda: jmpc_step(
        jocp, jsolver.model, jsolver.info, jsolver.cfg,
        JSqpSettings(num_iterations=1), 0.0, jnp.asarray(x0), jt, jms,
        jnp.zeros((N, 30)), jnp.zeros((N + 1, 30)), 0.0, True,
        ee_wrench=jnp.asarray(wrench)))()
    _close(jp, step(torch.tensor(wrench)))
