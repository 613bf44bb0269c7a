"""Device events (kernels, copies, fills) per batched MPC step of the
traced segment: what a cut of host dispatch moves, and free of
noise."""
from qmbench import spans as S

UNIT = "launches"


def read(ctx):
    return S.per_step(S.launches(ctx.trace), ctx.trace)
