"""CUDA graphs on the card: `GraphRunner` captures and replays them, and
`segment` cuts a capture into segments."""
import contextlib
import threading

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_unflatten

_COUNTS = {}                    # runner name -> [eager, captures, replays]
_COUNT_LOCK = threading.Lock()  # runners may run on several threads


def counts(name):
    """(eager, captures, replays): calls of the runners called `name` since
    import, on any thread. Eager: CPU tensors, or a key's first call; the
    capturing call replays too. Hit share: replays / all calls."""
    with _COUNT_LOCK:
        return tuple(_COUNTS.get(name, (0, 0, 0)))


def _count(name, i):
    with _COUNT_LOCK:
        _COUNTS.setdefault(name, [0, 0, 0])[i] += 1


# the capture in progress on this thread: `cut` starts its next segment
_capture = threading.local()
# one capture at a time in the process: a capture's synchronise and
# empty_cache fail while a stream of another thread captures (the MRT
# worker's solve beside the control thread's plant write)
_CAPTURE_LOCK = threading.Lock()


def segment(name):
    """Start the capture's next segment, a CUDA graph replayed under the
    range `name` (None: glue, under no range of its own), so that a trace
    of a replay still names the stages (Kineto links only part of a
    replayed graph's kernels to them). Outside a capture on this thread it
    does nothing."""
    cut = getattr(_capture, "cut", None)
    if cut is not None:
        cut(name)


def _range(name):
    return record_function(name) if name else contextlib.nullcontext()


def _key(leaves, spec):
    """A call's input signature: the pytree structure, each tensor's
    shape, dtype and device, every other leaf by value (by identity where
    it has no hash)."""
    parts = []
    for a in leaves:
        if isinstance(a, torch.Tensor):
            parts.append((tuple(a.shape), a.dtype, a.device))
        else:
            try:
                hash(a)
                parts.append(a)
            except TypeError:
                parts.append(("id", id(a)))
    return spec, tuple(parts)


class _Capture:
    """One capture of the runner's fn on static inputs: a CUDA graph per
    segment, all in the runner's pool, replayed in the order captured."""

    def __init__(self, runner, leaves, spec):
        dev = next(a.device for a in leaves if isinstance(a, torch.Tensor))
        leaves = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in leaves]
        self.inputs = [a for a in leaves if isinstance(a, torch.Tensor)]
        self.segments = []          # [(range or None, CUDAGraph)]
        self.stream = torch.cuda.current_stream(dev)
        self.pool = runner._pool
        with _CAPTURE_LOCK, record_function(f"{runner.name}.graph_capture"):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()    # the first call's cache, for the pool
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(self.stream)
            with torch.cuda.stream(side):
                self._cut(runner.first)
                _capture.cut = self._cut
                try:
                    out = runner.fn(*tree_unflatten(leaves, spec))
                finally:        # never leave the thread capturing
                    _capture.cut = None
                    self.segments[-1][1].capture_end()
            self.stream.wait_stream(side)
        self.out, self.out_spec = tree_flatten(out)

    def _cut(self, name):
        if self.segments:
            self.segments[-1][1].capture_end()
        g = torch.cuda.CUDAGraph()
        self.segments.append((name, g))
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def __call__(self, leaves, span, op):
        stream = torch.cuda.current_stream(self.inputs[0].device)
        if stream != self.stream:   # the last replay may still read inputs
            stream.wait_stream(self.stream)
            self.stream = stream
        for s, a in zip(self.inputs,
                        (a for a in leaves if isinstance(a, torch.Tensor))):
            s.copy_(a)
        with _range(span):
            for name, g in self.segments:
                with _range(name), _RecordFunctionFast(op):
                    g.replay()
        return tree_unflatten([a.clone() if isinstance(a, torch.Tensor)
                               else a for a in self.out], self.out_spec)


class GraphRunner:
    """fn(*args), replayed as CUDA graphs on the card.

    A call's key is its input signature (`_key`). On CPU tensors fn runs
    eagerly. On the card a key's first call runs eagerly (it fills the
    constant caches, the cuBLAS and cuSOLVER handles and the allocator);
    its second captures fn on a side stream and replays it; every later
    call copies its tensors into the capture's inputs and replays on the
    caller's current stream. A call returns fresh tensors (clones of the
    capture's outputs): a replay never writes into a tensor a caller
    holds.

    name: the counters (`counts`) and the host ops `<name>.graph_capture`
    around a capture and `<name>.graph_replay` around each segment's
    replay, under which a trace finds the segment's kernels. span: the
    range around a whole replay (fn's outermost range), or None. first:
    the range of the first segment (None: glue).

    A captured key keeps its graphs as long as the runner lives, so a
    runner should see few signatures. Its keys share one memory pool: a
    key's outputs are cloned right after its replay, before another key
    replays over them; one runner serves one thread at a time."""

    SEEN = 8            # keys seen once that are remembered, newest kept

    def __init__(self, fn, name, span=None, first=None):
        self.fn, self.name, self.span, self.first = fn, name, span, first
        self._graphs = {}
        self._seen = {}     # key -> its non-tensor leaves (ids stay taken)
        self._pool = None   # the captures' memory pool, from the first one

    def __call__(self, *args):
        leaves, spec = tree_flatten(args)
        tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
        graphs = None
        if tensors and all(a.is_cuda for a in tensors):
            key = _key(leaves, spec)
            graphs = self._graphs.get(key)
            if graphs is None and key in self._seen:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graphs = self._graphs[key] = _Capture(self, leaves, spec)
                del self._seen[key]
                _count(self.name, 1)
            elif graphs is None:
                self._seen[key] = [a for a in leaves
                                   if not isinstance(a, torch.Tensor)]
                if len(self._seen) > self.SEEN:
                    del self._seen[next(iter(self._seen))]
        if graphs is None:
            _count(self.name, 0)
            return self.fn(*args)
        out = graphs(leaves, self.span, f"{self.name}.graph_replay")
        _count(self.name, 2)
        return out
