"""The reference's side of the closed-loop fleet's check: a period of
`reference/cycle.py` recomputed from a recorded state and compared with
what was recorded, one scenario-period per job, in a pool of processes
where there is more than one job to a worker (the reference is plain
single-threaded Python: a period at full size takes seconds of a CPU
core)."""
import contextlib

import torch

from qmbench import traffic
from qmbench.compare import worst

NUMBERS = ("cost_rel", "X_gap", "tau_gap", "q_gap", "v_gap")
_MEMO = {}


def inputs_at(cfg, tr, block):
    """(lo, knot times, knot states) of the held target over [lo, lo +
    span_s], lo = block * rebuild_s; each side builds its gait schedule
    over the same span. A function of the time alone, so that no window,
    however fast, runs off their end."""
    lo = block * tr["rebuild_s"]
    times, states = traffic.knots(cfg, tr)
    return lo, [lo + t for t in times], states


def reference(cfg, tr, dtype=torch.float64, device="cpu"):
    """(Cycle, inputs(block) -> (Target, Schedule)) of the reference."""
    from qmbench import reference as R
    from qmbench.reference.cycle import Cycle, check_config, f32_schedule
    from qmbench.reference.mpc import Target
    R.check_config(cfg)
    check_config(cfg)
    robot, info = R.model(dtype, device)
    cyc = Cycle(robot, info, cfg["mpc"]["time_horizon"], cfg["mpc"]["dt"],
                cfg["control_freq"], cfg["mpc"]["mpc_frequency"],
                cfg["substeps"])
    memo = {}

    def inputs(block):
        if block not in memo:
            lo, times, states = inputs_at(cfg, tr, block)
            memo[block] = (Target(times, states, dtype, device),
                           f32_schedule(*traffic.gait_events(
                               cfg, lo + tr["span_s"])))
        return memo[block]
    return cyc, inputs


@contextlib.contextmanager
def float32_interior_point():
    """While it is open, the reference WBC's interior point
    (reference/wbc.py `qp`) keeps the iterations before the one at which
    float32 rounds the complementarity s'lam to 0, where its centring
    step would divide by it (the trot stacks of the float32 control reach
    it; float64 never does). qp with k iterations runs the first k of the
    same sequence, so the last k that does not divide by 0 is found by
    bisection."""
    from qmbench.reference import wbc as W
    real = W.qp

    def qp(H, c, G, h, iters=60):
        try:
            return real(H, c, G, h, iters)
        except ZeroDivisionError:
            lo, hi = 0, iters       # real(..., lo) returns, hi raises
            while hi - lo > 1:
                mid = (lo + hi) // 2
                try:
                    real(H, c, G, h, mid)
                    lo = mid
                except ZeroDivisionError:
                    hi = mid
            return real(H, c, G, h, max(lo, 1))
    W.qp = qp
    try:
        yield
    finally:
        W.qp = real


def gaps(job):
    """{number: gap} of one recorded scenario-period (cfg, traffic, block,
    state before, recorded outputs) against the reference in float64 on
    the CPU."""
    cfg, tr, block, st, got = job
    torch.set_num_threads(1)
    key = (cfg["name"], tuple(sorted(tr.items())))
    if key not in _MEMO:
        _MEMO[key] = reference(cfg, tr)
    cyc, inputs = _MEMO[key]
    f64 = lambda a: a.to("cpu", torch.float64)  # noqa
    with torch.no_grad():
        new, ref = cyc.run(st, *inputs(block))
    return dict(
        cost_rel=float((f64(got["cost"]) - ref["cost"]).abs()
                       / torch.clamp(ref["cost"].abs(), min=1.0)),
        X_gap=float((f64(got["X"]) - ref["X"]).abs().max()),
        tau_gap=float((f64(got["tau"]) - ref["tau"]).abs().max()),
        q_gap=float((f64(got["q"]) - new["q"]).abs().max()),
        v_gap=float((f64(got["v"]) - new["v"]).abs().max()))


def all_gaps(jobs, workers=1):
    """[gaps(job)] in order; `workers` processes (spawned, so that none
    inherits the card's context) when there is more than one job each."""
    if workers <= 1 or len(jobs) <= 1:
        return [gaps(j) for j in jobs]
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
        return pool.map(gaps, jobs, chunksize=1)


def largest(results):
    """{number: the largest gap}; a NaN or an infinity wins."""
    out = {k: 0.0 for k in NUMBERS}
    for r in results:
        for k in NUMBERS:
            worst(out, k, r[k])
    return out
