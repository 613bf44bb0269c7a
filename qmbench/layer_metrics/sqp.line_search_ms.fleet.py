"""Host ms of the port's `sqp.line_search` range (solver/sqp.py) per
batched MPC step of the traced segment, on the window's thread
alone."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "sqp.line_search"), ctx.trace)
