"""100 - the share of an untraced period in which a kernel, a copy or a
fill runs on the device: the union of their intervals in the traced
segment, per period, over the untraced window's mean period."""
from qmbench import trace as T

UNIT = "%"


def read(ctx):
    return T.idle_pct(ctx.trace, ctx.steps)
