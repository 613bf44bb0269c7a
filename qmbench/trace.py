"""Reduction of a torch.profiler trace to what the per-layer readers use.

`capture` profiles a few steps of a driver (CPU and CUDA activity) inside
one `qmbench.window` range and returns a `Trace`: the events as plain
tuples, the window, and the device's busy intervals. The busy share is
the union of the intervals in which a kernel, a copy or a fill ran on the
device, clipped to the window, and not the sum of kernel times over a
step (which counts overlapping kernels twice and reads the step on the
host's clock): this replaces chip_smoke.py:1358-1372 `_device_profile`.

The events are read from the profiler's raw Kineto results; the profiler's
own post-processing into FunctionEvents (a tree over every host op) is
never run, since it takes minutes for the ~10^5 ops of a batched step.
"""
import bisect
from collections import defaultdict
from typing import NamedTuple

WINDOW = "qmbench.window"


class Event(NamedTuple):
    name: str
    device: bool          # ran on the device (kernel, copy, fill)
    annotation: bool      # a record_function range (host or device copy)
    start: int            # ns, the profiler's clock
    end: int
    thread: int
    corr: int             # correlation id of a host op
    linked: int           # the host op a device event or a runtime call
    #                       belongs to (0: none)


class Trace(NamedTuple):
    events: list          # [Event]
    window: tuple         # (start ns, end ns) of the qmbench.window range
    thread: int           # the thread that ran the window
    busy: list            # merged [(start, end)] of device work, clipped
    steps: int            # steps profiled

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy) * 1e-9


def events_of(prof):
    """[Event] from a stopped torch.profiler.profile."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    out = []
    for e in raw:
        dev = e.device_type() != DeviceType.CPU
        ann = bool(e.is_user_annotation())
        out.append(Event(e.name(), dev and not ann, ann, e.start_ns(),
                         e.end_ns(), e.start_thread_id(), e.correlation_id(),
                         e.linked_correlation_id()))
    return out


def merge(intervals):
    """Union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def build(events, steps):
    """A Trace from [Event]; raises when the window range is missing."""
    wins = [e for e in events if e.name == WINDOW and e.annotation
            and not e.device]
    if not wins:
        raise RuntimeError("the trace has no qmbench.window range")
    w = max(wins, key=lambda e: e.end - e.start)
    lo, hi = w.start, w.end
    busy = merge((max(e.start, lo), min(e.end, hi)) for e in events
                 if e.device and e.end > lo and e.start < hi)
    return Trace(events, (lo, hi), w.thread, busy, steps)


def capture(step, steps, cuda=True):
    """Profile `steps` calls of step() (each ends synchronised) inside one
    qmbench.window range; returns (Trace, [step results]). cuda=False
    traces the host alone (the CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    results = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                results.append(step())
            if cuda:
                torch.cuda.synchronize()
    return build(events_of(prof), steps), results


def host_span_ms(trace, name):
    """Total host ms of the record_function ranges called `name` in the
    window (None when there are none)."""
    lo, hi = trace.window
    spans = [e.end - e.start for e in trace.events
             if e.annotation and not e.device and e.name == name
             and e.start >= lo and e.end <= hi]
    return sum(spans) * 1e-6 if spans else None


def idle_pct(trace, steps):
    """100 x the share of an untraced step in which nothing runs on the
    device: the device's busy time per step of the traced segment over the
    mean step of the untraced window `steps` [(t0, t1, units, tag)]. The
    profiler stretches the host's side of a traced step (up to twice, a
    fleet step) but hardly the kernels, so the traced segment's own idle
    share would read high."""
    if not trace.busy or not steps or trace.steps <= 0:
        return None
    step_s = (steps[-1][1] - steps[0][0]) / len(steps)
    return 100.0 * (1.0 - trace.busy_s / trace.steps / step_s)


def _outermost(intervals):
    """The outermost of possibly nested [(start, end, thread)]."""
    out = []
    for a, b, t in sorted(intervals):
        if out and out[-1][2] == t and a < out[-1][1]:
            continue
        out.append((a, b, t))
    return out


def device_time_under(trace, op_name):
    """(calls, device seconds): the outermost host ops called `op_name` in
    the window, and the time of the device work launched under them (the
    device events whose host op lies inside one of those calls)."""
    lo, hi = trace.window
    host = {e.corr: e for e in trace.events
            if not e.device and not e.annotation and not e.linked}
    calls = _outermost([(e.start, e.end, e.thread) for e in host.values()
                        if e.name == op_name and e.start >= lo
                        and e.end <= hi])
    if not calls:
        return 0, 0.0
    starts = [c[0] for c in calls]
    ns = 0
    for e in trace.events:
        if not e.device or not e.linked:
            continue
        op = host.get(e.linked)
        if op is None:
            continue
        i = bisect.bisect_right(starts, op.start) - 1
        if i >= 0 and op.end <= calls[i][1] and op.thread == calls[i][2]:
            ns += e.end - e.start
    return len(calls), ns * 1e-9


def breakdown(trace, top=10):
    """The contract's breakdown: the device operations that took most time,
    and the idle time of the device summed by what the host was doing
    beside it (the innermost record_function range and host op on the
    window's thread at the middle of each gap)."""
    lo, hi = trace.window
    by_name = defaultdict(int)
    for e in trace.events:
        if e.device and e.end > lo and e.start < hi:
            by_name[e.name] += min(e.end, hi) - max(e.start, lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, prev = [], lo
    for a, b in trace.busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = sorted((e for e in trace.events
                   if not e.device and e.thread == trace.thread
                   and e.end > lo and e.start < hi
                   and (e.annotation or not e.linked)
                   and e.name != WINDOW),
                  key=lambda e: (e.start, -e.end))
    idle = defaultdict(int)
    stacks = {True: [], False: []}
    i = 0
    for a, b in sorted(gaps):
        m = (a + b) // 2
        while i < len(host) and host[i].start <= m:
            st = stacks[host[i].annotation]
            while st and st[-1].end <= host[i].start:
                st.pop()
            st.append(host[i])
            i += 1
        label = []
        for kind in (True, False):
            st = stacks[kind]
            while st and st[-1].end < m:
                st.pop()
            label.append(st[-1].name if st else "-")
        idle["|".join(label)] += b - a
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in gap_list]}
