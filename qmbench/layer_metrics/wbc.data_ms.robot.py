"""Host ms of the port's `wbc.data` range (wbc/wbc.py: the measured and
desired data, the vmapped jacfwd of models/dynamics, and every task of
the stack) per tick of the traced segment, on the window's thread
alone."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "wbc.data"), ctx.trace)
