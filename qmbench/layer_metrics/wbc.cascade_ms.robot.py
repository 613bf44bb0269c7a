"""Host ms of the port's `wbc.cascade` range (wbc/wbc.py: the cascade's
operand checks and the hoqp_fused op with K1) per tick of the traced
segment, on the window's thread alone."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "wbc.cascade"), ctx.trace)
