"""Host ms of the port's `mpc.solve` range (mpc/mpc.py: the whole solve,
its `sqp.*` ranges included) per traced batched period, on the window's
thread alone. The cycle calls mpc_step itself, so the solve runs eagerly
here: this is the host's time of the whole solve, not the launch of a
graph."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "mpc.solve"), ctx.trace)
