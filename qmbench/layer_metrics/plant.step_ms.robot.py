"""Host ms of the port's `plant.step` range (runtime/plant.py: one plant
substep) per tick of the traced segment, every substep of the tick
together, on the window's thread alone."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    return S.per_step(S.host_ms(ctx.trace, "plant.step"), ctx.trace)
