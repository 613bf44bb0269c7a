"""The batched closed-loop cycle's ranges and counters in a torch.profiler
trace: parallel.make_batched_cycle at B = 1 (horizon 0.12 s of 0.04 s
nodes, 1 kHz ticks, one plant step each, trot), one traced period (on
CPU tensors K1's plain version solves a cascade op by op: the period is
~2.8 million profiler events, ~5 GB, and each scenario adds most of
that). Each
batched tick is one `loop.tick` range holding its WBC data, its cascade
and its plant step; `loop.estimate` runs under each tick and once under
the period's solve; runtime.loop's counters advance by the ticks and the
period, once per batched call.
"""
import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.mpc import mpc as M
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.parallel import make_batched_cycle
from qm_control_tpu_torch.runtime import loop as L
from qm_control_tpu_torch.runtime import plant as P
from qm_control_tpu_torch.wbc import wbc as W
from test_torch_spans import _inside, _named, _ranges

B = 1


@pytest.fixture(scope="module")
def period():
    """(ranges, the period's outer range, ticks per period, counter
    steps (ticks, cycles)) of one traced batched period."""
    torch.set_num_threads(1)
    cfg = _default_cfg(horizon=0.12, dt=0.04)
    model, info, q0, s = _standing_setup(cfg)
    lc = L.LoopConfig(control_freq=1000.0)
    vcycle, make_carries = make_batched_cycle(model, info, cfg, lc,
                                              device="cpu")
    start = L.ControlLoop(model, info, cfg, lc, device="cpu")
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["trot"]).mode_schedule(0.0, 3.0,
                                                         device="cpu")

    def tile(a):
        return a[None].expand(B, *a.shape).clone()
    target = type(target)(*map(tile, target))
    ms = type(ms)(*map(tile, ms))
    carries = vmap(start._warmup)(make_carries(q0, B), target, ms)
    ticks, cycles = L.tick_count, L.cycle_count
    out = []
    ranges, outer = _ranges(lambda: out.append(
        vcycle(carries, target, ms, cfg.wbc)))
    assert np.isfinite(out[0][1].torques.numpy()).all()
    steps = (L.tick_count - ticks, L.cycle_count - cycles)
    return ranges, outer, lc.ticks_per_cycle, steps


def test_one_tick_range_per_batched_tick(period):
    ranges, outer, n, _ = period
    ticks = _named(ranges, L.TICK_SPAN)
    assert n == 10 and len(ticks) == n
    assert all(_inside(t, outer) for t in ticks)


@pytest.mark.parametrize("name", [W.DATA_SPAN, W.CASCADE_SPAN,
                                  P.STEP_SPAN, M.EVALUATE_SPAN])
def test_each_tick_holds_its_stage_once(period, name):
    ranges, _, _, _ = period
    for tick in _named(ranges, L.TICK_SPAN):
        assert len([r for r in _named(ranges, name)
                    if _inside(r, tick)]) == 1, name


def test_estimate_runs_in_each_tick_and_once_before_the_solve(period):
    ranges, outer, n, _ = period
    est = _named(ranges, L.ESTIMATE_SPAN)
    ticks = _named(ranges, L.TICK_SPAN)
    solve, = _named(ranges, M.SOLVE_SPAN)
    for tick in ticks:
        assert len([e for e in est if _inside(e, tick)]) == 1
    outside = [e for e in est if not any(_inside(e, t) for t in ticks)]
    assert len(est) == n + 1 and len(outside) == 1
    assert _inside(outside[0], outer) and outside[0].end <= solve.start


def test_the_solve_comes_before_the_ticks(period):
    ranges, _, _, _ = period
    solve, = _named(ranges, M.SOLVE_SPAN)
    assert all(solve.end <= t.start for t in _named(ranges, L.TICK_SPAN))


def test_counters_advance_once_per_batched_call(period):
    _, _, n, steps = period
    assert steps == (n, 1)
