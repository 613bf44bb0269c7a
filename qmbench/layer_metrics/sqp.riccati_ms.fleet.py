"""Host ms of the port's `sqp.riccati` range (solver/sqp.py) per batched
MPC step of the traced segment."""
from qmbench import trace as T

UNIT = "ms"


def read(ctx):
    ms = T.host_span_ms(ctx.trace, "sqp.riccati")
    return None if ms is None else ms / ctx.trace.steps
