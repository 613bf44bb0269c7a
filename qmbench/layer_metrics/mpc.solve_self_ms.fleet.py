"""Host ms per batched MPC step of the traced segment inside the port's
`mpc.solve` range (mpc/mpc.py) but outside the `sqp.*` ranges nested in
it: the node data, the initializer, the warm-start shift, input_of and
the modes."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.self_ms(ctx.trace, "mpc.solve"), ctx.trace)
