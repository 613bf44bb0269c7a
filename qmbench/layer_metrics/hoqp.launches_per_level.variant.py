"""Device events (kernels, copies, fills) launched under the port's
`hoqp.level` ranges (wbc/hoqp.py: one level of the pivoted cascade, from
its Gram to its null-space update), over the number of those ranges, on
the window's thread alone: the launches a kernel for the cascade would
take away. Nothing where the port has no such range or the trace no
device."""
import bisect

from qmbench import spans as S

UNIT = "launches"
SPAN = "hoqp.level"


def read(ctx):
    tr = ctx.trace
    spans = S.host_ranges(tr, SPAN)
    if not spans:
        return None
    host = {e.corr: e for e in tr.events
            if not e.device and not e.annotation and not e.linked}
    starts = [a for a, _ in spans]
    n = 0
    for e in tr.events:
        op = host.get(e.linked) if e.device and e.linked else None
        if op is None or op.thread != tr.thread:
            continue
        i = bisect.bisect_right(starts, op.start) - 1
        if i >= 0 and op.end <= spans[i][1]:
            n += 1
    return n / len(spans) if n else None
