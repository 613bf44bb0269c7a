"""SimHardware's writes: runtime/plant.py's plant_write (push_command,
then the plant's substeps) replayed as CUDA graphs by the graph runner
"plant" (utils/graphs.py, tested on its own in test_torch_graphs.py).

On the CPU (tier 1): over 20 hold writes from the stance spawn (the
landing included) the runner gives what push_command and the substeps
give eagerly, bit for bit, counting only eager writes and never a
capture; SimHardware goes through it; a reference to a state's q, v or
anchors held across the next write is unchanged; a capture's segments
(utils/graphs.segment) start between the substeps, each substep in its
own plant.step range.

On the card (marker `card`; skipped without one, and run there with
`python3 -m pytest tests/test_torch_plant_graph.py --noconftest`): 20
writes through the runner against 20 eager writes from the same state,
torch.equal on every PlantState leaf; the counters read 1 eager write, 1
capture and 19 replays; references held across replays are unchanged;
replays on a stream of the caller's own give the same bits.
This file imports no JAX.
"""
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._pytree import tree_flatten

from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.runtime import hw as H
from qm_control_tpu_torch.runtime import plant as P
from qm_control_tpu_torch.utils import graphs as G

WRITES = 20
SUBSTEPS = 2


def _counters():
    return G.counts("plant")


def _delta(before):
    return tuple(b - a for a, b in zip(before, _counters()))


def _setup(device):
    """(model, the spawn's plant state, the plant step) on `device`."""
    model, _, q0, _ = _standing_setup(_default_cfg(horizon=0.12, dt=0.04))
    state = P.init_plant_state(q0, model=model, device=device)
    return model, state, P.make_plant_step(model, P.PlantConfig())


def _hold(state, k):
    """A hold command at the spawn's joints whose feed-forward moves with
    the write index k, so that every write pushes other values."""
    dev = state.q.device
    return P.HybridCommand(
        pos_des=state.q[6:].clone(), vel_des=torch.zeros(18, device=dev),
        kp=torch.full((18,), 80.0, device=dev),
        kd=torch.full((18,), 3.0, device=dev),
        ff=torch.full((18,), 0.05 * k, device=dev))


def _assert_equal(got, want, what):
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b), what


def _runner(model, state):
    """The runner of a SimHardware on the state's device:
    run(step, state, cmd, substeps)."""
    return H.SimHardware(model, state.q, device=state.q.device)._write


def _run(write, state, writes=WRITES):
    """`writes` hold writes through write(state, cmd): the states after
    each write."""
    spawn, out = state, []
    for k in range(writes):
        state = write(state, _hold(spawn, k))
        out.append(state)
    return out


# -- the CPU ------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu():
    torch.set_num_threads(1)
    return _setup(torch.device("cpu"))


def test_cpu_writes_equal_the_eager_write(cpu):
    model, state, step = cpu
    run = _runner(model, state)

    def eager(s, cmd):
        s = P.push_command(s, cmd)
        for _ in range(SUBSTEPS):
            s, _ = step(s)
        return s
    got = _run(lambda s, c: run(step, s, c, SUBSTEPS), state)
    want = _run(eager, state)
    for k, (a, b) in enumerate(zip(got, want)):
        assert type(a) is P.PlantState
        _assert_equal(a, b, f"write {k}")
    # the landing: the spawn at 0.38 m falls onto its feet
    assert float(got[-1].q[2]) < 0.38 and float(got[-1].t) == pytest.approx(
        WRITES * SUBSTEPS * P.PlantConfig().sim_dt)


def test_cpu_writes_count_eager_and_never_capture(cpu):
    model, state, step = cpu
    run = _runner(model, state)
    before = _counters()
    _run(lambda s, c: run(step, s, c, SUBSTEPS), state)
    assert _delta(before) == (WRITES, 0, 0)
    assert not run._graphs and not run._seen


def test_sim_hardware_writes_through_the_runner(cpu):
    model, state, step = cpu
    hw = H.SimHardware(model, state.q, device="cpu")
    assert isinstance(hw._write, G.GraphRunner)
    assert (hw._write.fn, hw._write.name) == (P.plant_write, "plant")
    before = _counters()
    for k in range(3):
        hw.write(_hold(state, k))
    want = _run(lambda s, c: P.plant_write(step, s, c, hw.substeps), state,
                writes=3)[-1]
    assert _delta(before) == (3, 0, 0)
    _assert_equal(hw.state, want, "SimHardware")
    assert hw.read().stamp == pytest.approx(3 * hw.substeps * hw._dt)


@pytest.mark.parametrize("field", ["q", "v", "anchors"])
def test_a_held_state_is_unchanged_by_the_next_write(cpu, field):
    model, state, step = cpu
    hw = H.SimHardware(model, state.q, device="cpu")
    hw.write(_hold(state, 0))
    held = getattr(hw.state, field)
    snapshot = held.clone()
    hw.write(_hold(state, 1))
    assert getattr(hw.state, field) is not held
    assert torch.equal(held, snapshot)


@pytest.mark.parametrize("substeps", [1, 2, 3])
def test_a_capture_cuts_between_the_substeps(cpu, substeps):
    """plant_write's cuts, as a capture sees them: a plant.step segment
    between each two substeps, none before the first (push_command goes
    with it), each substep in its own plant.step range."""
    model, state, step = cpu
    cuts = []
    G._capture.cut = cuts.append
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = P.plant_write(step, state, _hold(state, 0), substeps)
    finally:
        G._capture.cut = None
    assert cuts == [P.STEP_SPAN] * (substeps - 1)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.name() == P.STEP_SPAN]
    assert len(ranges) == substeps
    _assert_equal(out, P.plant_write(step, state, _hold(state, 0), substeps),
                  "a cut changes nothing")


# -- the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on the card: needs a card")
    return _setup(torch.device("cuda"))


def _snapshot(state):
    return [a.clone() for a in tree_flatten(state)[0]]


@pytest.mark.card
def test_replays_equal_eager_writes_bit_for_bit(card):
    model, state, step = card
    run = _runner(model, state)
    before = _counters()
    got, held = [], None
    spawn = state
    for k in range(WRITES):
        state = run(step, state, _hold(spawn, k), SUBSTEPS)
        got.append(state)
        if held is not None:        # write k - 1's state after write k
            _assert_equal(held[0], held[1], f"a replay wrote into {k - 1}")
        held = (tree_flatten(state)[0], _snapshot(state))
    want = _run(lambda s, c: P.plant_write(step, s, c, SUBSTEPS), spawn)
    torch.cuda.synchronize()
    assert _delta(before) == (1, 1, WRITES - 1)
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a, b, f"write {k}")
    assert float(got[-1].q[2]) < 0.38


@pytest.mark.card
def test_replays_on_the_callers_own_stream(card):
    """The asynchronous HardwareLoop ticks on a stream of its own: writes
    on another stream than the capture's, then back, replay the same
    bits."""
    model, state, step = card
    run = _runner(model, state)
    spawn = state
    side = torch.cuda.Stream()
    got = []
    for k in range(WRITES):
        with torch.cuda.stream(side) if 4 <= k < 14 else nullcontext():
            state = run(step, state, _hold(spawn, k), SUBSTEPS)
        got.append(state)
    torch.cuda.current_stream().wait_stream(side)
    want = _run(lambda s, c: P.plant_write(step, s, c, SUBSTEPS), spawn)
    torch.cuda.synchronize()
    assert len(run._graphs) == 1
    for k, (a, b) in enumerate(zip(got, want)):
        _assert_equal(a, b, f"write {k}")
