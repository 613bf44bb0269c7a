"""mpc/mpc.py's solve_runner: the MPC solve replayed as CUDA graphs by the
graph runner "mpc" (utils/graphs.py, tested on its own in
test_torch_graphs.py).

On the CPU (tier 1): the runner calls its function eagerly on CPU tensors
and returns what it returns, bit for bit, counting eager calls and never a
capture (MpcSolver.solve and the batched step alike); a solve with LU
solves (the parallel Riccati, or unrolled_ops off) gets no runner; the
SQP stages cut a capture into glue, sqp.linearize, sqp.riccati,
sqp.line_search, glue per iteration (also with the parallel Riccati).

On the card (marker `card`; skipped without one, and run there with
`python3 -m pytest tests/test_torch_mpc_graph.py --noconftest`): the
batched step at B = 8 over 4 steps (with the parallel Riccati eagerly
throughout) and MpcSolver.solve (one cold solve, then 3 warm ones) at full width give
what eager mpc_step gives, within 1e-6 relative; the counters read 1
eager call, 1 capture and replays for the rest; a policy returned by
call n is unchanged after call n+1; two batch shapes through one step
alternate, each replaying its own capture from the runner's one pool;
the asynchronous MRT worker captures once on its own thread and replays; the asynchronous
HardwareLoop ticks on its own stream and leaves its caller's alone.
This file imports no JAX.
"""
import time

import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.mpc import mpc as M
from qm_control_tpu_torch.ocp.problem import make_ocp
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.parallel import (BatchScenario,
                                           make_batched_mpc_step)
from qm_control_tpu_torch.runtime.estimator import (observation_from_rbd,
                                                    rbd_state_from_plant)
from qm_control_tpu_torch.solver.sqp import SqpSettings
from qm_control_tpu_torch.utils import graphs as G

SMALL = dict(horizon=0.12, dt=0.04)
SQP = ("sqp.linearize", "sqp.riccati", "sqp.line_search")
FIELDS = ("X", "W", "cost", "alpha")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on the card: needs a card")
    return torch.device("cuda")


def _counters():
    return G.counts("mpc")


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counters()))


def _problem(cfg, device, gait="stance"):
    """(model, info, x0, target, ms) of the standing spawn."""
    model, info, q0, s = _standing_setup(cfg)
    q = torch.as_tensor(q0)
    x0 = observation_from_rbd(model, info, rbd_state_from_plant(
        model, q, torch.zeros(24))).to(device)
    target = target_from_knots([0.0, 3.0], [s, s], device=device)
    ms = GaitSchedule(GAIT_LIBRARY[gait]).mode_schedule(0.0, 3.0,
                                                        device=device)
    return model, info, x0, target, ms


def _batch(cfg, x0, target, ms, B):
    """B scenarios, base heights spread over +-5 mm."""
    N, dev = cfg.mpc.num_nodes, x0.device

    def tile(a):
        return a[None].expand(B, *a.shape).clone()
    x = tile(x0)
    x[:, 8] += torch.linspace(-0.005, 0.005, B, device=dev)
    return BatchScenario(t=torch.zeros(B, device=dev), x=x,
                         target=type(target)(*map(tile, target)),
                         ms=type(ms)(*map(tile, ms)),
                         W_warm=torch.zeros(B, N, 30, device=dev),
                         X_warm=tile(x0[None].expand(N + 1, 30)))


def _eager_batched_step(model, info, cfg, settings):
    """make_batched_mpc_step's step with its vmap called directly."""
    ocp = make_ocp(model, info, cfg)

    def one(t, x, target, ms, W_warm, X_warm, shift, cold):
        return M.mpc_step(ocp, model, info, cfg, settings, t, x, target, ms,
                          W_warm, X_warm, shift, cold)
    vstep = vmap(one, in_dims=(0, 0, 0, 0, 0, 0, None, None))

    def step(batch):
        dev = batch.x.device
        shift = torch.tensor(1.0 / cfg.mpc.mpc_frequency, device=dev)
        cold = torch.zeros((), dtype=torch.bool, device=dev)
        policy = vstep(*batch, shift, cold)
        return batch._replace(W_warm=policy.W, X_warm=policy.X), policy
    return step


def _assert_close(got, want, what):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        scale = max(1.0, float(b.abs().max()))
        gap = float((a - b).abs().max())
        assert gap <= 1e-6 * scale, (what, name, gap, scale)


# -- the CPU ------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    torch.set_num_threads(1)
    cfg = _default_cfg(**SMALL)
    return (cfg, *_problem(cfg, torch.device("cpu")))


def _solve_args(cfg, model, info, x0, target, ms, cold, W=None, X=None):
    N = cfg.mpc.num_nodes
    W = torch.zeros(N, 30) if W is None else W
    X = torch.zeros(N + 1, 30) if X is None else X
    return (make_ocp(model, info, cfg), model, info, cfg,
            SqpSettings(num_iterations=1), torch.tensor(0.0), x0, target, ms,
            W, X, torch.tensor(0.01), torch.tensor(cold))


def test_cpu_calls_run_eagerly_and_return_what_mpc_step_returns(small):
    cfg, model, info, x0, target, ms = small
    args = _solve_args(cfg, model, info, x0, target, ms, True)
    run = M.solve_runner(M.mpc_step, args[4])
    before = _counters()
    cold = run(*args)
    warm_args = _solve_args(cfg, model, info, x0, target, ms, False,
                            cold.W, cold.X)
    warm = run(*warm_args)
    assert _delta(before) == (2, 0, 0)
    assert not run._graphs and not run._seen
    for got, want in ((cold, M.mpc_step(*args)),
                      (warm, M.mpc_step(*warm_args))):
        assert type(got) is M.MpcPolicy
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_cpu_solver_and_batched_step_never_capture(small):
    cfg, model, info, x0, target, ms = small
    solver = M.MpcSolver(model, info, cfg, device="cpu")
    step = make_batched_mpc_step(model, info, cfg)
    batch = _batch(cfg, x0, target, ms, 2)
    before = _counters()
    p1 = solver.solve(0.0, x0, target, ms)
    p2 = solver.solve(0.01, x0, target, ms)
    batch, q1 = step(batch)
    _, q2 = step(batch)
    assert _delta(before) == (4, 0, 0)
    for p in (p1, p2, q1, q2):
        assert torch.isfinite(p.cost).all() and torch.isfinite(p.X).all()


@pytest.mark.parametrize("parallel, unrolled, graphed", [
    (False, True, True), (True, True, False), (False, False, False)],
    ids=["serial", "parallel-riccati", "lu-solves"])
def test_only_solves_without_lu_get_a_runner(small, parallel, unrolled,
                                             graphed):
    cfg, model, info, x0, target, ms = small
    settings = SqpSettings(num_iterations=1, parallel_riccati=parallel,
                           unrolled_ops=unrolled)
    solver = M.MpcSolver(model, info, cfg, settings=settings, device="cpu")
    if graphed:
        assert isinstance(solver._step, G.GraphRunner)
        assert solver._step.fn is M.mpc_step
        assert (solver._step.name, solver._step.span) == ("mpc",
                                                          M.SOLVE_SPAN)
    else:
        assert solver._step is M.mpc_step


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("parallel", [False, True],
                         ids=["serial", "parallel-riccati"])
def test_the_stages_cut_a_capture_into_segments(small, iterations,
                                                parallel):
    """The cuts a capture sees: each stage starts its own segment and the
    acceptance after the line search one of glue, per iteration; no cut
    happens outside a capture."""
    cfg, model, info, x0, target, ms = small
    cuts = []
    args = list(_solve_args(cfg, model, info, x0, target, ms, True))
    args[4] = SqpSettings(num_iterations=iterations,
                          parallel_riccati=parallel)
    G._capture.cut = cuts.append
    try:
        policy = M.mpc_step(*args)
    finally:
        G._capture.cut = None
    assert cuts == [*SQP, None] * iterations
    assert torch.isfinite(policy.cost)
    M.mpc_step(*args)
    assert len(cuts) == 4 * iterations


# -- the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def full():
    """The benchmark's width (N = 67, 1 SQP iteration) on the card."""
    dev = _card()
    cfg = _default_cfg()
    return (cfg, *_problem(cfg, dev, gait="trot"))


def _snapshot(policy):
    return [a.clone() for a in policy]


@pytest.mark.card
@pytest.mark.parametrize("parallel", [False, True],
                         ids=["serial", "parallel-riccati"])
def test_the_batched_step_replays_what_eager_computes(full, parallel):
    cfg, model, info, x0, target, ms = full
    B, steps = 8, 4
    settings = SqpSettings(num_iterations=cfg.mpc.num_iterations,
                           parallel_riccati=parallel)
    step = make_batched_mpc_step(model, info, cfg, settings)
    eager = _eager_batched_step(model, info, cfg, settings)
    batch = ref = _batch(cfg, x0, target, ms, B)
    before = _counters()
    held = None
    for n in range(steps):
        batch, got = step(batch)
        ref, want = eager(ref)
        torch.cuda.synchronize()
        _assert_close(got, want, f"step {n}")
        if held is not None:        # call n's policy after call n + 1
            for a, b in zip(*held):
                assert torch.equal(a, b), "a replay wrote into a policy"
        held = (list(got), _snapshot(got))
        assert batch.W_warm.data_ptr() == got.W.data_ptr()
    # the eager reference calls its vmap directly: only the step counts;
    # the parallel Riccati's step has no runner (M.solve_runner)
    assert _delta(before) == ((0, 0, 0) if parallel else
                              (1, 1, steps - 1))


@pytest.mark.card
def test_two_batch_shapes_alternate_through_one_step(full):
    """B = 8 and B = 4 through one step, in turns: each shape captures on
    its second call, in the runner's one pool, and every replay matches
    eager, though a replay of one shape may overwrite the other's static
    outputs."""
    cfg, model, info, x0, target, ms = full
    settings = SqpSettings(num_iterations=cfg.mpc.num_iterations)
    step = make_batched_mpc_step(model, info, cfg, settings)
    eager = _eager_batched_step(model, info, cfg, settings)
    batches = [_batch(cfg, x0, target, ms, B) for B in (8, 4)]
    refs = list(batches)
    before = _counters()
    for n in range(6):
        i = n % 2
        batches[i], got = step(batches[i])
        refs[i], want = eager(refs[i])
        torch.cuda.synchronize()
        _assert_close(got, want, f"call {n}, B = {batches[i].x.shape[0]}")
    assert _delta(before) == (2, 2, 4)


@pytest.mark.card
def test_the_solver_replays_what_eager_computes(full):
    cfg, model, info, x0, target, ms = full
    solver = M.MpcSolver(model, info, cfg, device="cuda")
    eager = M.MpcSolver(model, info, cfg, device="cuda")
    eager._step = M.mpc_step
    before = _counters()
    held = None
    for n in range(4):                  # one cold solve, then 3 warm ones
        t = 0.01 * n
        got = solver.solve(t, x0, target, ms)
        want = eager.solve(t, x0, target, ms)
        torch.cuda.synchronize()
        _assert_close(got, want, f"solve {n}")
        if held is not None:
            for a, b in zip(*held):
                assert torch.equal(a, b), "a replay wrote into a policy"
        held = (list(got), _snapshot(got))
    assert _delta(before) == (1, 1, 3)
    assert solver._W_prev is got.W      # the warm start is the policy's


@pytest.mark.card
def test_the_mrt_worker_captures_on_its_own_thread():
    """The asynchronous MRT worker solves on its own stream: it captures
    once (thread-local capture) and replays from then on, while the
    control thread keeps the card busy on a stream of its own."""
    from qm_control_tpu_torch.runtime.mrt import MpcMrtInterface
    dev = _card()
    cfg = _default_cfg(**SMALL)
    model, info, x0, target, ms = _problem(cfg, dev)
    solver = M.MpcSolver(model, info, cfg, device=dev)
    mrt = MpcMrtInterface(solver, mpc_frequency=100.0)
    before = _counters()
    mrt.set_current_observation(0.0, x0, target, ms)
    mrt.start()
    try:
        deadline = time.time() + 120
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            while mrt.solve_count < 5 and time.time() < deadline:
                (x0[None] * torch.ones(64, 1, device=dev)).sum().item()
                time.sleep(0.005)
    finally:
        mrt.stop()
    assert mrt.solve_count >= 5
    eager, captures, replays = _delta(before)
    assert (eager, captures) == (1, 1) and replays == mrt.solve_count - 1
    x_des, u_des, mode = mrt.evaluate(0.02, x0)
    assert np.isfinite(x_des).all() and int(mode) == 15


@pytest.mark.card
def test_the_async_loop_ticks_on_its_own_stream():
    """HardwareLoop(async_mpc=True) at full width: its ticks run on the
    loop's stream while the worker replays the solve, and every tick
    leaves the caller on the stream it was on (here the legacy default
    stream, where a tick's launches would stall: ~10 s a tick)."""
    from qm_control_tpu_torch.runtime.hw import HardwareLoop, SimHardware
    dev = _card()
    cfg = _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    target = target_from_knots([0.0, 3.0], [s, s], device=dev)
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                            device=dev)
    hw = SimHardware(model, q0, substeps=2, device=dev)
    loop = HardwareLoop(model, info, cfg, hw, async_mpc=True,
                        mpc_freq=100.0, device=dev)
    default = torch.cuda.current_stream(dev)
    assert default == torch.cuda.default_stream(dev)
    before = _counters()

    def tick():
        t0 = time.perf_counter()
        res, _ = loop.tick(target, ms, hw.state.q[:3], hw.state.v[:3])
        tau = res.torques.cpu()
        assert torch.cuda.current_stream(dev) == default
        assert torch.isfinite(tau).all()
        return time.perf_counter() - t0
    loop.start(target, ms, hw.state.q[:3], hw.state.v[:3])
    try:
        deadline = time.time() + 180
        while _counters()[2] - before[2] < 3 and time.time() < deadline:
            tick()
        replays = _counters()[2]
        times = [tick() for _ in range(5)]
    finally:
        loop.stop()
    assert torch.cuda.current_stream(dev) == default
    assert _counters()[2] - before[2] >= 3, "the worker never replayed"
    assert _counters()[2] > replays, "no solve beside the timed ticks"
    assert sorted(times)[2] < 2.0, times
