"""Device ms under the port's `sqp.riccati` range (solver/sqp.py) per
batched MPC step of the traced segment: the union of the intervals of
the kernels, copies and fills that host ops inside the range
launched."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.device_ms_under(ctx.trace, "sqp.riccati"), ctx.trace)
