"""The port's record_function ranges, and the device work under them, read
from a `trace.Trace` for the per-layer readers.

Kineto records each record_function range twice when the device is
traced: the host range, and a device-side copy (a `gpu_user_annotation`,
from the first kernel the range launched to the end of the last) with the
same name, the same correlation id and the same thread id, which
`trace.events_of` reads as a host annotation (`trace.host_span_ms` counts
both). The readers here keep one event of each name and correlation id,
the first to start: the host range, which began before it launched the
kernel that starts its copy. They keep the window's thread alone (the
ranges of another thread, such as the MPC worker's, are not the tick's).
Each returns None, never 0, when it finds nothing to read: no such range,
or no device in the trace.
"""
import bisect

from qmbench import trace as T


def _host_annotations(trace):
    """The record_function ranges that ran on the window's thread inside
    the window, each once."""
    lo, hi = trace.window
    first = {}
    for e in trace.events:
        if e.annotation and not e.device and e.thread == trace.thread \
                and e.start >= lo and e.end <= hi:
            seen = first.get((e.name, e.corr))
            if seen is None or e.start < seen.start:
                first[(e.name, e.corr)] = e
    return first.values()


def host_ranges(trace, name):
    """[(start, end)] ns of the host ranges called `name`, in order."""
    return sorted((e.start, e.end) for e in _host_annotations(trace)
                  if e.name == name)


def host_ms(trace, name):
    """Total host ms of the ranges called `name`; None when there are
    none."""
    spans = host_ranges(trace, name)
    return sum(b - a for a, b in spans) * 1e-6 if spans else None


def self_ms(trace, name):
    """Total host ms of the ranges called `name` less, in each, the union
    of the other ranges nested inside it on the same thread (its child
    ranges); None when there are none."""
    spans = host_ranges(trace, name)
    if not spans:
        return None
    others = [(e.start, e.end) for e in _host_annotations(trace)
              if e.name != name]
    ns = 0
    for a, b in spans:
        inner = T.merge((s, e) for s, e in others if a <= s and e <= b)
        ns += (b - a) - sum(e - s for s, e in inner)
    return ns * 1e-6


def device_ms_under(trace, name):
    """Device ms under the ranges called `name`: the union of the
    intervals of the device events (kernels, copies, fills) whose host op
    lies inside one of them, linked as `trace.device_time_under` links
    them; None when no device event is."""
    spans = host_ranges(trace, name)
    if not spans:
        return None
    host = {e.corr: e for e in trace.events
            if not e.device and not e.annotation and not e.linked}
    starts = [a for a, _ in spans]
    under = []
    for e in trace.events:
        op = host.get(e.linked) if e.device and e.linked else None
        if op is None or op.thread != trace.thread:
            continue
        i = bisect.bisect_right(starts, op.start) - 1
        if i >= 0 and op.end <= spans[i][1]:
            under.append((e.start, e.end))
    if not under:
        return None
    return sum(b - a for a, b in T.merge(under)) * 1e-6


def launches(trace):
    """The device events (kernels, copies, fills) that started in the
    window; None when there are none."""
    lo, hi = trace.window
    n = sum(1 for e in trace.events if e.device and lo <= e.start < hi)
    return n or None


def per_step(value, trace):
    """`value` over the traced steps, None passed through."""
    return None if value is None else value / trace.steps
