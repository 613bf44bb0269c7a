"""The port's named stages in a torch.profiler trace, and the cycle timer.

One inline HardwareLoop tick that solves and one that does not (horizon
0.12 s of 0.04 s nodes, as tests/test_torch_hw.py), each under its own
CPU profiler session, and one make_batched_mpc_step call at B = 2: every
stage range of the modules' *_SPAN constants is on the tick's thread,
nests where the modules say, and appears as often as the stage runs.
RepeatedTimer times the card's stream with CUDA events, and a traced
replay of a solve captured as CUDA graphs still shows each stage range
once, with its kernels linked under it (card tests).
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.mpc import mpc as M
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.parallel import (BatchScenario,
                                           make_batched_mpc_step)
from qm_control_tpu_torch.runtime import hw as H
from qm_control_tpu_torch.runtime import plant as P
from qm_control_tpu_torch.runtime.estimator import (observation_from_rbd,
                                                    rbd_state_from_plant)
from qm_control_tpu_torch.utils import graphs as G
from qm_control_tpu_torch.utils.timers import RepeatedTimer
from qm_control_tpu_torch.wbc import wbc as W

HORIZON = dict(horizon=0.12, dt=0.04)
SQP = ("sqp.linearize", "sqp.riccati", "sqp.line_search")
OUTER = "test.tick"
SPANS = (H.ESTIMATE_SPAN, M.SOLVE_SPAN, *SQP, M.EVALUATE_SPAN, W.DATA_SPAN,
         W.CASCADE_SPAN, P.STEP_SPAN)


class Range(NamedTuple):
    name: str
    start: int
    end: int
    thread: int


def _ranges(fn):
    """fn() inside an OUTER range under a CPU profiler: the record_function
    ranges of the trace, and the OUTER one."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            fn()
    got = [Range(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    outer, = [r for r in got if r.name == OUTER]
    return [r for r in got if r.name != OUTER], outer


def _named(ranges, name):
    return [r for r in ranges if r.name == name]


def _inside(a, b):
    return b.start <= a.start and a.end <= b.end and a.thread == b.thread


@pytest.fixture(scope="module")
def ticks():
    """{"solve": ..., "plain": ...}: (ranges, the tick's range) of the
    first inline tick (it solves) and the second (it does not)."""
    torch.set_num_threads(1)
    cfg = _default_cfg(**HORIZON)
    model, info, q0, s = _standing_setup(cfg)
    hw = H.SimHardware(model, q0, device="cpu")
    loop = H.HardwareLoop(model, info, cfg, hw, async_mpc=False,
                          device="cpu")
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cpu")

    def tick():
        loop.tick(target, ms, hw.state.q[:3], hw.state.v[:3])
    out = {"solve": _ranges(tick), "plain": _ranges(tick)}
    assert loop.ticks_per_mpc > 2 and hw.substeps == 2
    return out


@pytest.mark.parametrize("name", SPANS)
def test_each_span_runs_on_the_tick_thread(ticks, name):
    ranges, tick = ticks["solve"]
    found = _named(ranges, name)
    assert found and all(_inside(r, tick) for r in found), found


def test_sqp_ranges_lie_inside_the_solve(ticks):
    ranges, _ = ticks["solve"]
    solve, = _named(ranges, M.SOLVE_SPAN)
    for name in SQP:
        found = _named(ranges, name)
        assert found and all(_inside(r, solve) for r in found), name


@pytest.mark.parametrize("kind", ["solve", "plain"])
def test_wbc_data_comes_before_the_cascade(ticks, kind):
    ranges, tick = ticks[kind]
    data, = _named(ranges, W.DATA_SPAN)
    cascade, = _named(ranges, W.CASCADE_SPAN)
    assert _inside(data, tick) and _inside(cascade, tick)
    assert data.end <= cascade.start


@pytest.mark.parametrize("kind", ["solve", "plain"])
def test_plant_steps_once_per_substep(ticks, kind):
    ranges, tick = ticks[kind]
    steps = _named(ranges, P.STEP_SPAN)
    assert len(steps) == 2 and all(_inside(r, tick) for r in steps)
    assert len(_named(ranges, H.ESTIMATE_SPAN)) == 1
    assert len(_named(ranges, M.EVALUATE_SPAN)) == 1


def test_a_plain_tick_has_no_solve(ticks):
    ranges, _ = ticks["plain"]
    assert not [r for r in ranges if r.name in (M.SOLVE_SPAN, *SQP)]


def test_the_batched_step_solves_once_around_the_sqp_ranges():
    torch.set_num_threads(1)
    cfg = _default_cfg(**HORIZON)
    model, info, q0, s = _standing_setup(cfg)
    q = torch.as_tensor(q0)
    x0 = observation_from_rbd(model, info,
                              rbd_state_from_plant(model, q,
                                                   torch.zeros(24)))
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cpu")
    B, N = 2, cfg.mpc.num_nodes

    def tile(a):
        return a[None].expand(B, *a.shape).clone()
    batch = BatchScenario(t=torch.zeros(B), x=tile(x0),
                          target=type(target)(*map(tile, target)),
                          ms=type(ms)(*map(tile, ms)),
                          W_warm=torch.zeros(B, N, 30),
                          X_warm=tile(x0[None].expand(N + 1, 30)))
    step = make_batched_mpc_step(model, info, cfg)
    out = []
    ranges, outer = _ranges(lambda: out.append(step(batch)))
    assert np.isfinite(out[0][1].cost.numpy()).all()
    solve, = _named(ranges, M.SOLVE_SPAN)
    assert _inside(solve, outer)
    for name in SQP:
        found = _named(ranges, name)
        assert found and all(_inside(r, solve) for r in found), name


def test_repeated_timer_on_the_cpu_uses_the_host_clock():
    t = RepeatedTimer("x", device="cpu")
    for _ in range(3):
        with t:
            torch.ones(64).sum()
    st = t.stats()
    assert t.count == st["count"] == 3 and st["min_ms"] >= 0.0


@pytest.mark.card
def test_repeated_timer_times_the_card_stream():
    """An interval holds the device time of a kernel enqueued inside it,
    though no synchronise ran before the timer stopped."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA events time the card's stream: needs a card")
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()
    k0 = torch.cuda.Event(enable_timing=True)
    k1 = torch.cuda.Event(enable_timing=True)
    t = RepeatedTimer("x", device="cuda")
    with t:
        k0.record()
        for _ in range(8):
            a = a @ a * 1e-3
        k1.record()
    assert t.count == 1
    st = t.stats()
    kernel_ms = k0.elapsed_time(k1)
    assert kernel_ms > 0.1 and st["min_ms"] >= kernel_ms


@pytest.mark.card
def test_a_graph_replay_keeps_the_stage_ranges():
    """A warm solve replayed from CUDA graphs (mpc/mpc.py solve_runner),
    traced: mpc.solve and each sqp.* range once on the host, each sqp.*
    range with device events launched under it (a kernel's host op lies
    inside the range), as qmbench/spans.py's readers link them."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on the card: needs a card")
    from torch.autograd import DeviceType
    cfg = _default_cfg(**HORIZON)
    model, info, q0, s = _standing_setup(cfg)
    x0 = observation_from_rbd(model, info, rbd_state_from_plant(
        model, torch.as_tensor(q0), torch.zeros(24))).cuda()
    target = target_from_knots([0.0, 3.0], [s, s], device="cuda")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cuda")
    solver = M.MpcSolver(model, info, cfg, device="cuda")
    for k in range(2):                  # eager, then the capture
        solver.solve(0.01 * k, x0, target, ms)
    replays = G.counts("mpc")[2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.solve(0.02, x0, target, ms)
        torch.cuda.synchronize()
    assert G.counts("mpc")[2] == replays + 1
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    ranges = {name: [(e.start_ns(), e.end_ns()) for e in host
                     if e.is_user_annotation() and e.name() == name]
              for name in (M.SOLVE_SPAN, *SQP)}
    assert all(len(r) == 1 for r in ranges.values()), ranges
    ops = {e.correlation_id(): e for e in host
           if not e.is_user_annotation() and not e.linked_correlation_id()}
    for name in SQP:
        (a, b), = ranges[name]
        under = [e for e in events if e.device_type() != DeviceType.CPU
                 and not e.is_user_annotation()
                 and e.linked_correlation_id() in ops
                 and a <= ops[e.linked_correlation_id()].start_ns()
                 and ops[e.linked_correlation_id()].end_ns() <= b]
        assert under, name
