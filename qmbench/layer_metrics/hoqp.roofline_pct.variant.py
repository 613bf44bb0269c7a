"""The pivoted cascade's share of its roofline: the least time the
cascades of the traced segment need on the card's published peaks
(counts/hoqp.py, from the MPC-only stack's shapes in the configuration),
over the device time of the work launched under the port's `wbc.cascade`
ranges. A cascade is three `hoqp.level` ranges (wbc/hoqp.py). Nothing
where the port has no such range or the trace no device."""
from qmbench import spans as S
from qmbench.counts.hoqp import hoqp_bound_s

UNIT = "%"
LEVELS = 3


def read(ctx):
    levels = S.host_ranges(ctx.trace, "hoqp.level")
    dev_ms = S.device_ms_under(ctx.trace, "wbc.cascade")
    if not levels or not dev_ms:
        return None
    cascades = len(levels) / LEVELS
    bound_s = hoqp_bound_s(ctx.config["wbc_stack"])
    return 100.0 * cascades * bound_s / (dev_ms * 1e-3)
