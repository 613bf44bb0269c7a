"""Median ms of the window's solve-bearing ticks (every ticks_per_mpc-th:
estimator, MPC solve, policy evaluation, WBC, K1, plant), from the
benchmark's own span around each synchronised tick."""
import statistics

UNIT = "ms"


def read(ctx):
    ms = [1e3 * (b - a) for a, b, _, tag in ctx.steps if tag == "solve"]
    return statistics.median(ms) if ms else None
