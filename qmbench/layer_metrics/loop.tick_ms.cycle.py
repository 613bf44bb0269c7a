"""Host ms of the port's `loop.tick` range (runtime/loop.py: one control
tick, the estimator, the policy's evaluation, the WBC and the plant
inside it) per traced batched tick, on the window's thread alone; nothing
where the port has no such range."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    ticks = S.host_ranges(ctx.trace, "loop.tick")
    if not ticks:
        return None
    return sum(b - a for a, b in ticks) * 1e-6 / len(ticks)
