"""PyTorch port vs JAX reference: runtime/mrt.py, the asynchronous MPC
worker and its policy double buffer.

evaluate_policy_np is the JAX package's numpy code: bit for bit equal to
it on one numpy policy, and within 1e-6 of the port's device
evaluate_policy. The asynchronous interface at horizon 0.12 s on the CPU,
mirroring tests/test_commands_utils.py::test_mrt_async_interface: the
initial policy within 120 s, stance mode 15, and the worker keeps
re-solving; with both policy slots (the native seqlock buffer and the
mutex slot). An exception in the worker is re-raised by stop(), which
joins the thread. Forward-mode AD from many threads at once (the worker's
solve beside the control tick's WBC) gives each thread its
single-threaded result bit for bit (models/_fwd.py's lock).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from qm_control_tpu.mpc.mpc import MpcPolicy as JPolicy
from qm_control_tpu.runtime.mrt import evaluate_policy_np as j_eval_np

from qm_control_tpu_torch.config import MpcConfig, QmConfig
from qm_control_tpu_torch.experiments import _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.mpc.mpc import MpcPolicy, MpcSolver, evaluate_policy
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.runtime import mrt as M

torch.set_num_threads(1)

TIMES = [-0.1, 0.0, 0.013, 0.05, 0.1999, 0.2, 0.5]


def _np_policy(seed=0, N=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(t_nodes=(0.04 * np.arange(N + 1)).astype(f32),
                X=rng.standard_normal((N + 1, 30)).astype(f32),
                U=rng.standard_normal((N + 1, 30)).astype(f32),
                modes=rng.integers(0, 16, N + 1).astype(np.int32),
                cost=f32(rng.standard_normal()),
                W=rng.standard_normal((N, 30)).astype(f32),
                alpha=f32(1.0), defect=f32(0.0))


@pytest.mark.parametrize("t", TIMES)
def test_evaluate_policy_np_matches_jax(t):
    p = _np_policy()
    x, u, mode = M.evaluate_policy_np(MpcPolicy(**p), t)
    jx, ju, jmode = j_eval_np(JPolicy(**p), t)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(u, ju)
    assert mode == jmode and isinstance(mode, int)
    tp = MpcPolicy(**{k: torch.as_tensor(v) for k, v in p.items()})
    dx, du, dmode = evaluate_policy(tp, t)
    np.testing.assert_allclose(dx.numpy(), x, rtol=0, atol=1e-6)
    np.testing.assert_allclose(du.numpy(), u, rtol=0, atol=1e-6)
    assert int(dmode) == mode


def test_native_slot_roundtrip():
    """The seqlock slot returns the written host policy bit for bit, in
    MpcPolicy field order with each field's shape and dtype."""
    slot = M._NativePolicySlot()
    assert slot.read() == (None, 0)
    p = MpcPolicy(**_np_policy(1))
    slot.write(p)
    got, version = slot.read()
    assert version == 1 and type(got) is MpcPolicy
    for a, b in zip(got, p):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def problem():
    cfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.12, dt=0.04,
                                         num_iterations=1))
    model, info, q0, s = _standing_setup(cfg)
    target = target_from_knots([0.0, 5.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 5.0,
                                                           device="cpu")
    x0 = torch.as_tensor(s[:30], dtype=torch.float32)
    x0[8] = 0.38
    return model, info, cfg, target, ms, x0


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native-seqlock", "mutex-slot"])
def test_async_interface(problem, use_native):
    model, info, cfg, target, ms, x0 = problem
    solver = MpcSolver(model, info, cfg, device="cpu")
    mrt = M.MpcMrtInterface(solver, mpc_frequency=50.0,
                            use_native=use_native)
    assert isinstance(mrt._policy, M._NativePolicySlot if use_native
                      else M._Slot)
    with pytest.raises(RuntimeError, match="no policy yet"):
        mrt.evaluate(0.0, x0)
    mrt.set_current_observation(0.0, x0, target, ms)
    mrt.start()
    th = mrt._thread
    try:
        deadline = time.time() + 120
        while not mrt.initial_policy_received() and time.time() < deadline:
            time.sleep(0.05)
        assert mrt.initial_policy_received(), "no policy within deadline"
        x_des, u_des, mode = mrt.evaluate(0.02, x0)
        assert x_des.shape == (30,) and u_des.shape == (30,)
        assert int(mode) == 15
        assert isinstance(mrt.get_policy().X, np.ndarray)
        n0 = mrt.solve_count
        mrt.set_current_observation(0.05, x0, target, ms)
        deadline = time.time() + 60
        while mrt.solve_count <= n0 and time.time() < deadline:
            time.sleep(0.05)
        assert mrt.solve_count > n0      # keeps re-solving at the pace
    finally:
        mrt.stop()
    assert not th.is_alive() and mrt._thread is None


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native-seqlock", "mutex-slot"])
def test_worker_exception_reraised_by_stop(problem, use_native):
    """The reference's MPC-thread exception trap: the worker stores what
    it raised and stops; stop() joins it and raises it."""
    model, info, cfg, target, ms, x0 = problem

    class Failing(MpcSolver):
        def solve(self, *a, **k):
            raise _Boom("solver failed")

    mrt = M.MpcMrtInterface(Failing(model, info, cfg, device="cpu"),
                            mpc_frequency=50.0, use_native=use_native)
    mrt.set_current_observation(0.0, x0, target, ms)
    mrt.start()
    th = mrt._thread
    th.join(timeout=30)
    assert not th.is_alive() and not mrt.initial_policy_received()
    with pytest.raises(_Boom, match="solver failed"):
        mrt.stop()


def test_forward_ad_from_many_threads():
    """More threads than cores, a short switch interval: every thread's
    jacfwd / jvp through models/_fwd.py equals the single-threaded result
    bit for bit, and none fails (unlocked, torch's process-global dual
    levels break: "no level exists")."""
    from qm_control_tpu_torch.models import dynamics as D
    from qm_control_tpu_torch.models import load_model
    from qm_control_tpu_torch.models._fwd import jacfwd, jvp
    model = load_model()
    q = torch.as_tensor(_standing_setup(None)[2]) + 0.01
    v = torch.linspace(-0.5, 0.5, 24)

    def work():
        return (jacfwd(lambda qq: D.potential_energy(model, qq))(q),
                jvp(lambda qq: D.mass_matrix(model, qq), (q,), (v,))[1])
    want = work()
    n = (os.cpu_count() or 1) + 4
    errors, results = [], []

    def run():
        try:
            for _ in range(3):
                results.append(work())
        except Exception as e:            # collected for the assertion
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:1]
    assert len(results) == 3 * n
    for got in results:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
