"""K1's share of its roofline at grid = B: the least time the cascades of
the traced segment need on the card's published peaks (counts/k1.py,
from the WBC stack's shapes in the configuration), over the device time
of whatever kernels ran under the `qm_control_tpu_torch::hoqp_fused` op.
Each call of a batched tick solves one cascade per scenario, the cell's
`traffic.batch`. Nothing when no such op ran."""
from qmbench import trace as T
from qmbench.counts.k1 import k1_bound_s

UNIT = "%"
OP = "qm_control_tpu_torch::hoqp_fused"


def read(ctx):
    calls, dev_s = T.device_time_under(ctx.trace, OP)
    if not calls or dev_s <= 0:
        return None
    cascades = calls * ctx.workload["traffic"]["batch"]
    return 100.0 * cascades * k1_bound_s(ctx.config["wbc_stack"]) / dev_s
