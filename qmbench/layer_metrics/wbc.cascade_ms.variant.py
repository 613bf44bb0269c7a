"""Host ms of the port's `wbc.cascade` range (wbc/wbc.py: the pivoted
cascade, wbc/hoqp.py, of one tick of the MPC-only controller) per traced
period, on the window's thread alone."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "wbc.cascade"), ctx.trace)
