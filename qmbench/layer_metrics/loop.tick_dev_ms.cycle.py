"""Device ms under the port's `loop.tick` range (runtime/loop.py) per
traced batched period: the union of the intervals of the kernels, copies
and fills that host ops inside a tick launched; nothing where the port
has no such range or the trace no device."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.device_ms_under(ctx.trace, "loop.tick"), ctx.trace)
