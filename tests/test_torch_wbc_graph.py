"""HierarchicalWbc's updates: wbc/wbc.py's data and task stack
(`wbc_stack`) through the graph runner "wbc" (utils/graphs.py, tested on
its own in test_torch_graphs.py), then the cascade (K1) and the torque
recovery eagerly.

On the CPU (tier 1): over ticks whose q, v, MPC input, contact flags and
time change every tick (the time crossing arm_settling_time), in stance
and in a trot, an update equals the functional hierarchical_wbc_update
on the wrapper's last input bit for bit; the runner counts only eager
calls and never a capture; the wrapper's last input advances to each
update's MPC input; the runner's outputs carry only what the cascade and
the torque recovery read.

On the card (marker `card`; skipped without one, and run there with
`python3 -m pytest tests/test_torch_wbc_graph.py --noconftest`): 20
updates against 20 eager hierarchical_wbc_update calls on the same
inputs, torch.equal on every WbcResult field; the counters read 1 eager
call, 1 capture and 19 replays, 18 of them of a graph captured before;
K1's launch_count grows by one per update; a WbcResult held across the
next update is unchanged; updates on a stream of the caller's own, as
the asynchronous HardwareLoop ticks, give the same bits.
This file imports no JAX.
"""
import dataclasses
from contextlib import nullcontext

import pytest
import torch

from qm_control_tpu_torch.config import WbcGains
from qm_control_tpu_torch.kernels import hoqp_fused as K
from qm_control_tpu_torch.models import centroidal as C
from qm_control_tpu_torch.models import default_q, load_model
from qm_control_tpu_torch.utils import graphs as G
from qm_control_tpu_torch.wbc import wbc as W

PERIOD = 0.002
SETTLING = 0.009        # the arm-settling gate opens at the 4th CPU tick
PATTERNS = {"stance": [(1., 1., 1., 1.)],
            "trot": [(1., 0., 0., 1.), (0., 1., 1., 0.)]}


def _counters():
    return G.counts("wbc")


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counters()))


@pytest.fixture(scope="module")
def robot():
    torch.set_num_threads(1)
    model = load_model()
    gains = dataclasses.replace(WbcGains(), arm_settling_time=SETTLING)
    return model, C.make_centroidal_info(model), gains


def _inputs(k, pattern, device):
    """Tick k's (state_des, input_des, q, v, flags, period, time): the
    standing pose and the stance forces, moved by a draw of tick k, so
    that every tick reads other values; time k * PERIOD + 0.004."""
    g = torch.Generator().manual_seed(1000 + k)

    def draw(n, scale):
        return scale * (2 * torch.rand(n, generator=g) - 1)
    q0 = torch.as_tensor(default_q(base_pos=(0, 0, 0.4)), dtype=torch.float32)
    x = torch.zeros(30)
    x[6:30] = q0 + draw(24, 0.02)
    x[:6] = draw(6, 0.1)
    u = torch.zeros(30)
    u[2:12:3] = 9.81 * 52.0 / 4
    u = u + draw(30, 1.0)
    q = q0 + draw(24, 0.02)
    v = draw(24, 0.2)
    flags = torch.tensor(pattern[k % len(pattern)])
    return [a.to(device) for a in (x, u, q, v, flags,
                                   torch.tensor(PERIOD),
                                   torch.tensor(k * PERIOD + 0.004))]


def _eager(robot, ticks, pattern, device):
    """hierarchical_wbc_update (K1) over the ticks, input_last the last
    tick's MPC input."""
    model, info, gains = robot
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=device)
    last = torch.zeros(30, device=device)
    out = []
    for k in range(ticks):
        x, u, q, v, flags, period, time = _inputs(k, pattern, device)
        out.append(W.hierarchical_wbc_update(model, info, gains, tau_max, x,
                                             u, last, q, v, flags, period,
                                             time))
        last = u
    return out


def _update(wbc, k, pattern, stream=None):
    with torch.cuda.stream(stream) if stream is not None else nullcontext():
        return wbc.update(*_inputs(k, pattern, wbc.device))


def _assert_equal(got, want, what):
    for name, a, b in zip(W.WbcResult._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {name}"


# -- the CPU ------------------------------------------------------------------

CPU_TICKS = 8


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_cpu_updates_equal_the_functional_update(robot, pattern):
    model, info, gains = robot
    wbc = W.HierarchicalWbc(model, info, gains, device="cpu")
    got = [_update(wbc, k, PATTERNS[pattern]) for k in range(CPU_TICKS)]
    want = _eager(robot, CPU_TICKS, PATTERNS[pattern], "cpu")
    for k, (a, b) in enumerate(zip(got, want)):
        assert type(a) is W.WbcResult
        _assert_equal(a, b, f"tick {k}")
    # the arm-settling gate opened inside the run: T1 changed stacks
    times = [float(_inputs(k, PATTERNS[pattern], "cpu")[6])
             for k in (0, CPU_TICKS - 1)]
    assert times[0] < SETTLING <= times[1]


def test_cpu_updates_count_eager_and_never_capture(robot):
    wbc = W.HierarchicalWbc(*robot, device="cpu")
    assert isinstance(wbc._stack, G.GraphRunner)
    assert (wbc._stack.name, wbc._stack.span) == ("wbc", W.DATA_SPAN)
    before = _counters()
    for k in range(3):
        _update(wbc, k, PATTERNS["trot"])
    assert _delta(before) == (3, 0, 0)
    assert not wbc._stack._graphs and not wbc._stack._seen


def test_cpu_input_last_advances(robot):
    wbc = W.HierarchicalWbc(*robot, device="cpu")
    assert torch.equal(wbc._input_last, torch.zeros(30))
    for k in range(3):
        _update(wbc, k, PATTERNS["stance"])
        u = _inputs(k, PATTERNS["stance"], "cpu")[1]
        assert wbc._input_last.dtype == torch.float32
        assert torch.equal(wbc._input_last, u)


def test_the_runner_returns_what_the_cascade_and_torques_read(robot):
    """The runner clones every output: the data it returns is the
    WbcData's q, M, h and Jc, and the three levels whole."""
    model, info, gains = robot
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32)
    x, u, q, v, flags, period, time = _inputs(0, PATTERNS["trot"], "cpu")
    args = (x, u, torch.zeros(30), q, v, flags, period, time)
    m, stack = W._robot_stack(model, info, gains, tau_max, *args)
    full, want = W.wbc_stack(model, info, gains, tau_max, *args)
    kept = {f for f in m._fields if getattr(m, f) is not None}
    assert kept == set(W._TORQUE_FIELDS)
    for f in kept:
        assert torch.equal(getattr(m, f), getattr(full, f)), f
    for t, w in zip(stack, want):
        for a, b in zip(t, w):
            assert torch.equal(a, b)


# -- the card -----------------------------------------------------------------

CARD_TICKS = 20


@pytest.fixture(scope="module")
def card(robot):
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on the card: needs a card")
    return robot, torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_replays_equal_eager_updates_bit_for_bit(card, pattern):
    robot, dev = card
    wbc = W.HierarchicalWbc(*robot, device=dev)
    got = [_update(wbc, k, PATTERNS[pattern]) for k in range(CARD_TICKS)]
    want = _eager(robot, CARD_TICKS, PATTERNS[pattern], dev)
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a, b, f"tick {k}")
    assert all(torch.isfinite(r.torques).all() for r in got)


@pytest.mark.card
def test_the_hit_share_and_k1_launches(card):
    """A capture on the second update, replays after it; K1 launches once
    per update, outside the graph."""
    robot, dev = card
    wbc = W.HierarchicalWbc(*robot, device=dev)
    before, launches = _counters(), K.launch_count
    for k in range(CARD_TICKS):
        n = K.launch_count
        _update(wbc, k, PATTERNS["trot"])
        assert K.launch_count == n + 1, f"K1 launches at tick {k}"
    torch.cuda.synchronize()
    assert K.launch_count - launches == CARD_TICKS
    eager, captures, replays = _delta(before)
    assert (eager, captures, replays) == (1, 1, CARD_TICKS - 1)
    # the ticks that replayed a graph captured before: all but two
    assert (replays - captures) / CARD_TICKS == (CARD_TICKS - 2) / CARD_TICKS


@pytest.mark.card
def test_a_held_result_is_unchanged_by_the_next_update(card):
    robot, dev = card
    wbc = W.HierarchicalWbc(*robot, device=dev)
    held = None
    for k in range(6):
        res = _update(wbc, k, PATTERNS["trot"])
        if held is not None:    # tick k - 1's result after tick k
            torch.cuda.synchronize()
            for name, a, b in zip(W.WbcResult._fields, *held):
                assert torch.equal(a, b), f"tick {k} wrote into {name}"
        torch.cuda.synchronize()
        held = (list(res), [a.clone() for a in res])


@pytest.mark.card
def test_replays_on_the_callers_own_stream(card):
    """The asynchronous HardwareLoop ticks on a stream of its own:
    updates on another stream than the capture's, then back, replay the
    same bits."""
    robot, dev = card
    wbc = W.HierarchicalWbc(*robot, device=dev)
    side = torch.cuda.Stream()
    got = [_update(wbc, k, PATTERNS["trot"], side if 4 <= k < 14 else None)
           for k in range(CARD_TICKS)]
    torch.cuda.current_stream().wait_stream(side)
    want = _eager(robot, CARD_TICKS, PATTERNS["trot"], dev)
    torch.cuda.synchronize()
    assert len(wbc._stack._graphs) == 1
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a, b, f"tick {k}")
