"""utils/graphs.py: the CUDA-graph runner and the segment cuts of a capture.

On the CPU (tier 1): a call's key is its input signature (the pytree
structure, each tensor's shape and dtype, other leaves by value, an int
such as the plant's substeps too, unhashable ones by identity); calls on
CPU tensors run fn eagerly, return what it returns and count as eager,
never as a capture; segment() does nothing outside a capture, and a
capture in progress on one thread sees no cut from another.

On the card (marker `card`; skipped without one, and run there with
`python3 -m pytest tests/test_torch_graphs.py --noconftest`): a runner
remembers its 8 newest keys seen once and its captures share one memory
pool; a capture that raises (a host read inside fn) leaves the thread
able to run eagerly; a thread that asks for a capture while another
captures (as the MRT worker's solve and the control thread's plant write
may) waits its turn, and both replay what eager computes.
This file imports no JAX.
"""
import sys
import threading

import pytest
import torch
from torch.utils._pytree import tree_flatten

from qm_control_tpu_torch.utils import graphs as G


def _delta(name, before):
    return tuple(b - a for a, b in zip(before, G.counts(name)))


def _tensor(shape=(2, 3), dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


class _Unhashable:
    __hash__ = None


_SHARED = _Unhashable()


@pytest.mark.parametrize("other, same", [
    ((_tensor(), 1.0, _SHARED, 2), True),          # values do not matter
    ((_tensor((3, 2)), 1.0, _SHARED, 2), False),   # a shape
    ((_tensor(dtype=torch.float64), 1.0, _SHARED, 2), False),   # a dtype
    ((_tensor(), 2.0, _SHARED, 2), False),         # a non-tensor leaf's value
    ((_tensor(), 1.0, _Unhashable(), 2), False),   # an unhashable leaf's id
    (((_tensor(),), 1.0, _SHARED, 2), False),      # the structure
    ((_tensor(), 1.0, _SHARED, 3), False),         # an int (substeps)
], ids=["values", "shape", "dtype", "leaf", "identity", "structure", "int"])
def test_a_key_is_the_input_signature(other, same):
    def key(args):
        leaves, spec = tree_flatten(args)
        return G._key(leaves, spec)
    base = (torch.ones(2, 3), 1.0, _SHARED, 2)
    assert (key(base) == key(other)) is same


def _fn(x, k):
    return (2.0 * x + 1.0).sin() * k, {"sum": x.sum()}


def test_cpu_calls_run_eagerly_and_count_as_eager():
    run = G.GraphRunner(_fn, "test.cpu")
    before = G.counts("test.cpu")
    x = torch.linspace(0, 1, 5)
    for _ in range(3):
        got = run(x, 3)
        want = _fn(x, 3)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1]["sum"], want[1]["sum"])
    assert _delta("test.cpu", before) == (3, 0, 0)
    assert not run._graphs and not run._seen


def test_segment_does_nothing_outside_a_capture():
    assert getattr(G._capture, "cut", None) is None
    G.segment("a stage")
    G.segment(None)
    cuts = []
    G._capture.cut = cuts.append        # a capture on this thread
    try:
        other = threading.Thread(target=G.segment, args=("elsewhere",))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        G.segment("here")
        G.segment(None)
    finally:
        G._capture.cut = None
    assert cuts == ["here", None]


# -- the card -----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs replay on the card: needs a card")
    return torch.device("cuda")


@pytest.mark.card
def test_a_runner_remembers_few_keys_and_shares_one_pool():
    dev = _card()
    run = G.GraphRunner(lambda x: (2.0 * x + 1.0).sin(), "test.keys")
    xs = [torch.linspace(0, 1, n, device=dev) for n in range(1, 11)]
    for x in xs:
        run(x)
    assert len(run._seen) == G.GraphRunner.SEEN and not run._graphs
    before = G.counts("test.keys")
    for x in (xs[0], xs[-1], xs[-2], xs[-1]):   # xs[0] was forgotten
        assert torch.equal(run(x), (2.0 * x + 1.0).sin())
    assert _delta("test.keys", before) == (1, 2, 3)
    assert [c.pool for c in run._graphs.values()] == [run._pool] * 2


@pytest.mark.card
def test_a_capture_that_raises_leaves_the_thread_eager():
    """fn reads a sum to the host, which a capture refuses: the capturing
    call raises, and the thread is left capturing nothing, with no cut
    set, and runs the next key eagerly."""
    dev = _card()
    run = G.GraphRunner(lambda x: x * float(x.sum()), "test.raise")
    x = torch.ones(4, device=dev)
    before = G.counts("test.raise")
    assert torch.equal(run(x), 4.0 * x)         # eager
    with pytest.raises(RuntimeError):
        run(x)                                  # the capture
    assert not torch.cuda.is_current_stream_capturing()
    assert getattr(G._capture, "cut", None) is None
    y = torch.arange(3.0, device=dev)
    assert torch.equal(run(y), 3.0 * y)         # another key: eager
    torch.cuda.synchronize()
    assert _delta("test.raise", before) == (2, 0, 0)


def _long(x):
    """~6,000 kernels: a capture of it takes a while on the host."""
    for _ in range(2000):
        x = (0.999 * x + 0.001).sin()
    return x


@pytest.mark.card
def test_two_threads_capture_at_once():
    """Thread 1 asks for a capture while thread 0 captures: a capture
    synchronises the device first, which fails while a stream of another
    thread captures, so the captures take turns."""
    dev = _card()
    capturing = threading.Event()

    def first(x):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
        return _long(x)
    runs = [G.GraphRunner(first, "test.threads"),
            G.GraphRunner(_long, "test.threads")]
    xs = [torch.linspace(0, 1, 64 * (i + 1), device=dev) for i in range(2)]
    want = [_long(x) for x in xs]
    torch.cuda.synchronize()            # the threads' streams wait on none
    got, errors = [None, None], []
    both = threading.Barrier(2, timeout=60)

    def work(i):
        try:
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                runs[i](xs[i])          # eager
                both.wait()
                if i == 1:              # thread 0 is capturing now
                    assert capturing.wait(timeout=60)
                outs = [runs[i](xs[i]) for _ in range(3)]   # capture, replays
            stream.synchronize()
            got[i] = outs
        except Exception as e:          # reported by the main thread
            errors.append(e)
    before = G.counts("test.threads")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    for outs, w in zip(got, want):
        assert all(torch.equal(o, w) for o in outs)
    assert _delta("test.threads", before) == (2, 2, 6)
