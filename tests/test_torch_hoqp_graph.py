"""The MPC-only controller's pivoted cascade (wbc/hoqp.py) through the
graph runner "hoqp" (wbc/wbc.py pivoted_runner over utils/graphs.py,
tested on its own in test_torch_graphs.py), as runtime/mpc_loop.py
make_mpc_cycle calls it.

On the CPU (tier 1), at the cut horizon of test_torch_variant_spans.py
(0.12 s of 0.04 s nodes), stance, LoopConfig()'s 500 Hz ticks: the
runner's first segment is the first level and the cascade cuts before
each later level, so a replay opens one `hoqp.level` range per level;
a period of MpcControlLoop calls the runner once a tick (eagerly on CPU
tensors, never a capture) and equals, bit for bit, a period whose ticks
call hoqp_solve directly; the cascade and level counters advance by one
and three a tick through the runner; the K1 cycle (fused_wbc=True) makes
no runner.

On the card (marker `card`; skipped without one, and run there with
`python3 -m pytest tests/test_torch_hoqp_graph.py --noconftest`): 10
MPC-only updates through the runner against 10 eager ones on the same
inputs, torch.equal on x_opt and the torques; the counters read 1 eager
call, 1 capture and 9 replays (8 of a graph captured before), the
cascade counters one and three an update; a torch.profiler trace of two
replays holds three `hoqp.level` ranges in each `wbc.cascade` range, and
device events linked to host ops inside each `wbc.cascade` range (what
qmbench's `hoqp.*.variant` readers read).
This file imports no JAX.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qm_control_tpu_torch.config import WbcGains
from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.models import centroidal as C
from qm_control_tpu_torch.models import load_model
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.runtime import loop as L
from qm_control_tpu_torch.runtime import mpc_loop as ML
from qm_control_tpu_torch.utils import graphs as G
from qm_control_tpu_torch.wbc import hoqp as H
from qm_control_tpu_torch.wbc import wbc as W
from test_torch_wbc_graph import PATTERNS, _inputs


def _counters():
    """(runner "hoqp"'s eager, captures, replays, cascades, levels)."""
    return (*G.counts("hoqp"), H.solve_count, H.level_count)


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counters()))


def _recording_runners(monkeypatch):
    """The GraphRunners that wbc.pivoted_runner makes from now on."""
    made = []

    class Recording(G.GraphRunner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(W, "GraphRunner", Recording)
    return made


def _mpc_update(robot, k, pattern, device, last, cascade=None):
    """hierarchical_mpc_wbc_update on tick k's inputs."""
    model, info, gains = robot
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=device)
    x, u, q, v, flags, period, _ = _inputs(k, pattern, device)
    return W.hierarchical_mpc_wbc_update(model, info, gains, tau_max, x, u,
                                         last, q, v, flags, period,
                                         cascade=cascade), u


@pytest.fixture(scope="module")
def robot():
    torch.set_num_threads(1)
    model = load_model()
    return model, C.make_centroidal_info(model), WbcGains()


# -- the CPU ------------------------------------------------------------------

def test_a_capture_cuts_one_segment_per_level(robot, monkeypatch):
    """What a capture would do (utils/graphs.py _Capture): open the
    runner's first segment, then let the cascade cut the others. Each cut
    falls between two levels' interior points."""
    made = _recording_runners(monkeypatch)
    W.pivoted_runner()
    runner, = made
    assert (runner.name, runner.span, runner.first) == ("hoqp", None,
                                                        H.LEVEL_SPAN)
    model, info, gains = robot
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32)
    x, u, q, v, flags, period, _ = _inputs(0, PATTERNS["stance"], "cpu")
    _, stack = W.mpc_wbc_stack(model, info, gains, tau_max, x, u,
                               torch.zeros(30), q, v, flags, period)
    qps, cuts = [], []
    real_qp = H.solve_qp

    def counting_qp(*args, **kwargs):
        qps.append(1)
        return real_qp(*args, **kwargs)
    monkeypatch.setattr(H, "solve_qp", counting_qp)
    G._capture.cut = lambda name: cuts.append((name, len(qps)))
    try:
        before = _counters()
        runner.fn(*stack)
    finally:
        G._capture.cut = None
    assert [runner.first] + [c[0] for c in cuts] == [H.LEVEL_SPAN] * 3
    assert [c[1] for c in cuts] == [1, 2] and len(qps) == 3
    # the captured body counts nothing: the runner's caller counts
    assert _delta(before) == (0,) * 5


@pytest.fixture(scope="module")
def variant(robot):
    """(loop, carry after one warm-up solve, target, mode schedule) of the
    MPC-only controller at the cut horizon, stance."""
    cfg = _default_cfg(horizon=0.12, dt=0.04)
    model, info, q0, s = _standing_setup(cfg)
    loop = ML.MpcControlLoop(model, info, cfg, L.LoopConfig(), device="cpu")
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cpu")
    carry = loop.warmup(loop.init_carry(q0), target, ms, num_solves=1)
    return loop, carry, target, ms


def test_a_period_through_the_runner_equals_direct_hoqp_solve(
        variant, monkeypatch):
    loop, carry, target, ms = variant
    ticks = loop.loop_cfg.ticks_per_cycle
    before = _counters()
    got = loop.run(carry, target, ms, 1)
    # every tick's cascade through the runner, eagerly on the CPU, counted
    assert ticks == 5 and _delta(before) == (ticks, 0, 0, ticks, 3 * ticks)
    monkeypatch.setattr(ML, "pivoted_runner", lambda: (
        lambda t0, t1, t2: H.hoqp_solve([t0, t1, t2])))
    direct = ML.make_mpc_cycle(loop.model, loop.info, loop.cfg,
                               loop.loop_cfg, device="cpu")
    before = _counters()
    carry_d, m_d = direct(carry, target, ms, loop.gains)
    assert _delta(before) == (0, 0, 0, ticks, 3 * ticks)
    carry_r, m_r = got
    for name, a, b in zip(ML.MpcCycleMetrics._fields, m_r, m_d):
        assert torch.equal(a[0], b), name
    flat = torch.utils._pytree.tree_flatten
    for a, b in zip(flat(carry_r)[0], flat(carry_d)[0]):
        assert a is b is None or torch.equal(a, b)


def test_the_k1_cycle_makes_no_runner(variant, monkeypatch):
    loop, _, _, _ = variant

    def refused():
        raise AssertionError("the K1 cycle made a runner")
    monkeypatch.setattr(ML, "pivoted_runner", refused)
    ML.make_mpc_cycle(loop.model, loop.info, loop.cfg, loop.loop_cfg,
                      fused_wbc=True, device="cpu")
    with pytest.raises(AssertionError, match="made a runner"):
        ML.make_mpc_cycle(loop.model, loop.info, loop.cfg, loop.loop_cfg,
                          device="cpu")


# -- the card -----------------------------------------------------------------

CARD_TICKS = 10


@pytest.fixture(scope="module")
def card(robot):
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on the card: needs a card")
    return robot, torch.device("cuda")


def _updates(robot, pattern, dev, cascade, ticks=CARD_TICKS):
    last = torch.zeros(30, device=dev)
    out = []
    for k in range(ticks):
        res, last = _mpc_update(robot, k, PATTERNS[pattern], dev, last,
                                cascade)
        out.append(res)
    return out


@pytest.mark.card
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_replays_equal_eager_updates_bit_for_bit(card, pattern):
    robot, dev = card
    before = _counters()
    got = _updates(robot, pattern, dev, W.pivoted_runner())
    torch.cuda.synchronize()
    eager, captures, replays, cascades, levels = _delta(before)
    assert (eager, captures, replays) == (1, 1, CARD_TICKS - 1)
    assert replays - captures == CARD_TICKS - 2
    assert (cascades, levels) == (CARD_TICKS, 3 * CARD_TICKS)
    want = _updates(robot, pattern, dev, None)
    torch.cuda.synchronize()
    assert G.counts("hoqp")[:3] == tuple(
        a + b for a, b in zip(before[:3], (eager, captures, replays)))
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.x_opt.dtype == b.x_opt.dtype == torch.float32
        assert torch.equal(a.x_opt, b.x_opt), f"tick {k}: x_opt"
        assert torch.equal(a.torques, b.torques), f"tick {k}: torques"
    assert all(bool(torch.isfinite(r.torques).all()) for r in got)


@pytest.mark.card
def test_a_traced_replay_keeps_three_levels_in_each_cascade(card):
    """Two replays under torch.profiler: each `wbc.cascade` range holds
    three `hoqp.level` ranges, and device events whose host op lies
    inside it (the links qmbench/spans.py's readers follow)."""
    from torch.autograd import DeviceType
    robot, dev = card
    cascade = W.pivoted_runner()
    last = torch.zeros(30, device=dev)
    for k in range(2):                  # eager, then the capture
        _, last = _mpc_update(robot, k, PATTERNS["trot"], dev, last, cascade)
    torch.cuda.synchronize()
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(2, 4):
            _, last = _mpc_update(robot, k, PATTERNS["trot"], dev, last,
                                  cascade)
        torch.cuda.synchronize()
    assert _delta(before) == (0, 0, 2, 2, 6)
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == DeviceType.CPU]

    def ranges(name):
        return sorted((e.start_ns(), e.end_ns()) for e in host
                      if e.is_user_annotation() and e.name() == name)
    cascades, levels = ranges(W.CASCADE_SPAN), ranges(H.LEVEL_SPAN)
    assert len(cascades) == 2 and len(levels) == 6
    ops = {e.correlation_id(): e for e in host
           if not e.is_user_annotation() and not e.linked_correlation_id()}
    for a, b in cascades:
        assert len([1 for s, e in levels if a <= s and e <= b]) == 3
        under = [e for e in events if e.device_type() != DeviceType.CPU
                 and not e.is_user_annotation()
                 and e.linked_correlation_id() in ops
                 and a <= ops[e.linked_correlation_id()].start_ns()
                 and ops[e.linked_correlation_id()].end_ns() <= b]
        assert under, (a, b)
