"""Host ms of the port's `mpc.solve` range (mpc/mpc.py: the whole solve,
its `sqp.*` ranges included) per solve of the traced segment, on the
window's thread alone; nothing when the segment holds no solve."""
from qmbench import spans as S

UNIT = "ms"


def read(ctx):
    solves = S.host_ranges(ctx.trace, "mpc.solve")
    if not solves:
        return None
    return sum(b - a for a, b in solves) * 1e-6 / len(solves)
