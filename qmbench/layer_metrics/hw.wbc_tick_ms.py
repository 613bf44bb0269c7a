"""Median ms of the window's other ticks (estimator, policy evaluation,
WBC data, K1, plant), from the benchmark's own span around each
synchronised tick."""
import statistics

UNIT = "ms"


def read(ctx):
    ms = [1e3 * (b - a) for a, b, _, tag in ctx.steps if tag == "wbc"]
    return statistics.median(ms) if ms else None
