"""The reference's side of the MPC-only controller's check: a period of
`reference/variant.py` recomputed from a recorded state and compared with
what was recorded, one period per job, in a pool of processes where
there is more than one job (the reference is plain single-threaded
Python: a period at full size takes seconds of a CPU core)."""
import torch

from qmbench import cycle_check, traffic

NUMBERS = ("cost_rel", "X_gap", "arm_cmd_gap", "tau_gap", "q_gap", "v_gap",
           "level_gap")
_MEMO = {}


def reference(cfg, tr, dtype=torch.float64, device="cpu"):
    """(Variant, inputs(block) -> (Target, Schedule)) of the reference."""
    from qmbench import reference as R
    from qmbench.reference.cycle import f32_schedule
    from qmbench.reference.mpc import Target
    from qmbench.reference.variant import Variant, check_config
    R.check_config(cfg)
    check_config(cfg)
    robot, info = R.model(dtype, device)
    var = Variant(robot, info, cfg["mpc"]["time_horizon"], cfg["mpc"]["dt"],
                  cfg["control_freq"], cfg["mpc"]["mpc_frequency"],
                  cfg["substeps"])
    memo = {}

    def inputs(block):
        if block not in memo:
            lo, times, states = cycle_check.inputs_at(cfg, tr, block)
            memo[block] = (Target(times, states, dtype, device),
                           f32_schedule(*traffic.gait_events(
                               cfg, lo + tr["span_s"])))
        return memo[block]
    return var, inputs


def level_gap(o_port, o_ref, limit):
    """The lexicographic gap of the port's per-level objectives against
    the reference's (chip_smoke.py phase 4f's rule): the largest excess
    of a level's objective over the reference's, over max(|o|, 1), from
    the top level down to the first where the port's is the better by
    more than `limit`; NaN where an objective is."""
    gap = 0.0
    for a, b in zip(o_port, o_ref):
        d = (a - b) / max(abs(b), 1.0)
        if not d == d:
            return float("nan")
        gap = max(gap, d)
        if d < -limit:
            break
    return gap


def gaps(job):
    """{number: gap} of one recorded period (cfg, traffic, block, state
    before, recorded outputs, the level limit) against the reference in
    float64 on the CPU."""
    from qmbench.reference.variant import objectives, stack
    from qmbench.reference.wbc import cascade
    cfg, tr, block, st, got, limit = job
    torch.set_num_threads(1)
    key = (cfg["name"], tuple(sorted(tr.items())))
    if key not in _MEMO:
        _MEMO[key] = reference(cfg, tr)
    var, inputs = _MEMO[key]
    f64 = lambda a: a.to("cpu", torch.float64)  # noqa
    with torch.no_grad():
        new, ref = var.run(st, *inputs(block))
        tick = {k: f64(v) for k, v in got["tick"].items()
                if torch.is_tensor(v)}
        tick["period"] = var.tick_dt
        _, lv = stack(var.robot, var.mpc.ocp, tick)
        o_ref = objectives(lv, cascade(*lv))
        o_port = objectives(lv, tick["x"])
    return dict(
        cost_rel=float((f64(got["cost"]) - ref["cost"]).abs()
                       / torch.clamp(ref["cost"].abs(), min=1.0)),
        X_gap=float((f64(got["X"]) - ref["X"]).abs().max()),
        arm_cmd_gap=float((f64(got["arm_cmd"]) - ref["arm_cmd"]).abs()
                          .max()),
        tau_gap=float((f64(got["tau"]) - ref["tau"]).abs().max()),
        q_gap=float((f64(got["q"]) - new["q"]).abs().max()),
        v_gap=float((f64(got["v"]) - new["v"]).abs().max()),
        level_gap=level_gap(o_port, o_ref, limit), o_port=o_port,
        o_ref=o_ref)


def all_gaps(jobs, workers=1):
    """[gaps(job)] in order; `workers` processes (spawned, so that none
    inherits the card's context) when there is more than one job."""
    if workers <= 1 or len(jobs) <= 1:
        return [gaps(j) for j in jobs]
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
        return pool.map(gaps, jobs, chunksize=1)
