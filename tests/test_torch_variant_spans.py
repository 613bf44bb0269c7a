"""The MPC-only controller's ranges and counters in a torch.profiler
trace: one period of MpcControlLoop (runtime/mpc_loop.py make_mpc_cycle,
the pivoted cascade) on the CPU at a cut horizon (0.12 s of 0.04 s
nodes), stance, LoopConfig()'s 500 Hz ticks. Each tick is one
`loop.tick` range holding its WBC data, its cascade (three `hoqp.level`
ranges) and its plant steps; `loop.estimate` runs under each tick and
once before the period's solve; runtime.loop's tick and cycle counters
and wbc/hoqp.py's cascade and level counters advance once per call.
"""
import numpy as np
import pytest
import torch

from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.mpc import mpc as M
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.runtime import loop as L
from qm_control_tpu_torch.runtime import plant as P
from qm_control_tpu_torch.runtime.mpc_loop import MpcControlLoop
from qm_control_tpu_torch.wbc import hoqp as H
from qm_control_tpu_torch.wbc import wbc as W
from test_torch_spans import _inside, _named, _ranges


@pytest.fixture(scope="module")
def period():
    """(ranges, the period's outer range, ticks per period, counter steps
    (ticks, cycles, cascades, levels)) of one traced period."""
    torch.set_num_threads(1)
    cfg = _default_cfg(horizon=0.12, dt=0.04)
    model, info, q0, s = _standing_setup(cfg)
    loop = MpcControlLoop(model, info, cfg, L.LoopConfig(), device="cpu")
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cpu")
    carry = loop.warmup(loop.init_carry(q0), target, ms, num_solves=1)
    before = (L.tick_count, L.cycle_count, H.solve_count, H.level_count)
    out = []
    ranges, outer = _ranges(lambda: out.append(
        loop.run(carry, target, ms, 1)))
    assert np.isfinite(out[0][1].torques.numpy()).all()
    after = (L.tick_count, L.cycle_count, H.solve_count, H.level_count)
    steps = tuple(b - a for a, b in zip(before, after))
    return ranges, outer, loop.loop_cfg.ticks_per_cycle, steps


def test_one_tick_range_per_tick(period):
    ranges, outer, n, _ = period
    ticks = _named(ranges, L.TICK_SPAN)
    assert n == 5 and len(ticks) == n
    assert all(_inside(t, outer) for t in ticks)


@pytest.mark.parametrize("name", [W.DATA_SPAN, W.CASCADE_SPAN,
                                  M.EVALUATE_SPAN])
def test_each_tick_holds_its_stage_once(period, name):
    ranges, _, _, _ = period
    for tick in _named(ranges, L.TICK_SPAN):
        assert len([r for r in _named(ranges, name)
                    if _inside(r, tick)]) == 1, name


def test_each_tick_holds_its_plant_substeps(period):
    ranges, _, _, _ = period
    for tick in _named(ranges, L.TICK_SPAN):
        assert len([r for r in _named(ranges, P.STEP_SPAN)
                    if _inside(r, tick)]) == 2


def test_each_cascade_holds_three_levels(period):
    ranges, _, n, _ = period
    levels = _named(ranges, H.LEVEL_SPAN)
    cascades = _named(ranges, W.CASCADE_SPAN)
    assert len(levels) == 3 * n and len(cascades) == n
    for c in cascades:
        inside = [lv for lv in levels if _inside(lv, c)]
        assert len(inside) == 3
        assert all(a.end <= b.start for a, b in zip(inside, inside[1:]))


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
    assert all(solve.end <= t.start for t in ticks)


def test_counters_advance_once_per_call(period):
    _, _, n, steps = period
    assert steps == (n, 1, n, 3 * n)
