"""Driver of `runtime.mpc_loop.MpcControlLoop`, the port's MPC-only
controller (upstream's QMMpcController): one robot, one control period
after another (the estimator, one warm-started solve whose fresh policy
the period's ticks execute, the arm command integrated from it, then the
ticks, each the MPC-only WBC through the pivoted cascade, the hybrid law
and the plant substeps), each synchronised. A step is one period; the
rate counts periods per second.

Set-up: the port's loop from the seed's spawn (its base height drawn
within +-height_spread), the controller's start (`warmup_solves` solves
that do not advance the plant), then the cell's warm-up periods, which
carry the window past the landing from the spawn.

Correctness, after the window, from what the timed path produced: the
plain reference (`reference/variant.py`, float64 on the CPU, in a pool
of `workers` processes on the card's machine; `variant_check.py`)
recomputes the window's first period and `periods` more drawn from the
seed among the later ones, each whole from the port's carry at its
start. The driver keeps a reference to those carries (the loop replaces
a carry's tensors and never writes into them). Numbers, each the largest
over the periods: cost_rel and X_gap (the fresh policy), arm_cmd_gap
(rad, the arm command), tau_gap (Nm, the last tick's leg torques), q_gap
and v_gap (the plant after the period), and level_gap: the last tick's
cascade, the port's solution against the reference's on the levels the
reference builds from the port's inputs of that tick, level by level
(the lexicographic rule of chip_smoke.py phase 4f: each level's
objective above the reference's, over max(|o|, 1), until a level where
the port is the better by more than the limit). The last tick's inputs
and solution are the ones the period's metrics return
(`mpc_loop.MpcCycleMetrics`); a port without them cannot run the cell,
and the driver says so before it builds anything.
"""
import contextlib

import torch
from torch.profiler import record_function

from qmbench import cycle_check, settings, traffic, variant_check
from qmbench.compare import worst


def loop_config(cfg, loop_module, plant_module):
    """The port's LoopConfig of the configuration (LoopConfig()'s values
    in the cell's configuration)."""
    return loop_module.LoopConfig(
        control_freq=cfg["control_freq"],
        mpc_freq=cfg["mpc"]["mpc_frequency"], leg_kd=cfg["leg_kd"],
        plant=plant_module.PlantConfig(**cfg["plant"]))


def _check_port(cfg, lc, mpc_loop):
    """Refuse a configuration that the port's loop would not run as it
    states: the substeps of a tick, the fresh policy, the arm command's
    period and the arm's position gains."""
    if lc.substeps_per_tick != cfg["substeps"] or \
            cfg["mrt_policy_lag"] != 0 or \
            mpc_loop.ARM_CMD_PERIOD != cfg["arm_cmd_period"] or \
            not torch.equal(mpc_loop.ARM_POS_KP,
                            torch.tensor(cfg["arm_pos_kp"])) or \
            not torch.equal(mpc_loop.ARM_POS_KD,
                            torch.tensor(cfg["arm_pos_kd"])):
        raise ValueError("the port's MPC-only loop has other settings than "
                         "the configuration's")


def _state(carry):
    """A port carry as the reference's period state."""
    b = carry.base
    return dict(q=b.plant.q, v=b.plant.v, anchors=b.plant.anchors,
                W=b.W_warm, X=b.X_warm, u_last=b.input_last, yaw=b.last_yaw,
                t=float(b.t))


def _cpu(d):
    return {k: (_cpu(v) if isinstance(v, dict) else v.cpu()
                if torch.is_tensor(v) else v) for k, v in d.items()}


class Driver:
    def __init__(self, cfg, wl, seed, device):
        from qm_control_tpu_torch import config as port_config
        from qm_control_tpu_torch import models
        from qm_control_tpu_torch.models import centroidal
        from qm_control_tpu_torch.runtime import loop as L
        from qm_control_tpu_torch.runtime import mpc_loop as ML
        from qm_control_tpu_torch.runtime import plant as P
        from qmbench.drivers.fleet_cycle import wbc_gains
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, device
        qc = settings.qm_config(port_config, cfg)
        model, info = settings.model_and_info(models, centroidal)
        if not hasattr(ML, "MpcCycleMetrics"):
            raise RuntimeError("the port's MPC-only loop does not return "
                               "its last tick's WBC (MpcCycleMetrics)")
        lc = loop_config(cfg, L, P)
        _check_port(cfg, lc, ML)
        self.period = 1.0 / cfg["mpc"]["mpc_frequency"]
        self.loop = ML.MpcControlLoop(model, info, qc, lc,
                                      gains=wbc_gains(cfg, qc), device=device)
        self.q0 = traffic.robot_spawn(cfg, seed)
        self.block = None
        self._inputs(0)
        self.carry = self.loop.init_carry(self.q0)
        self.periods = 0          # periods run since the start
        self.metrics = []         # every window period's metrics
        self.records = []         # (block, carry before, metrics, carry
        #                           after) of every window period;
        #                           release() keeps the sampled

    def _inputs(self, block):
        """The port's target and mode schedule of `block`."""
        if block == self.block:
            return
        from qm_control_tpu_torch.gaits.library import (GAIT_LIBRARY,
                                                        GaitSchedule)
        from qm_control_tpu_torch.ocp.reference import target_from_knots
        tr = self.wl["traffic"]
        lo, times, states = cycle_check.inputs_at(self.cfg, tr, block)
        self.target = target_from_knots(times, states, device=self.dev)
        self.ms = GaitSchedule(GAIT_LIBRARY[self.cfg["gait"]]).mode_schedule(
            lo, lo + tr["span_s"], device=self.dev)
        self.block = block

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, traced=False):
        ctx = record_function("qmbench.period") if traced \
            else contextlib.nullcontext()
        t = self.periods * self.period
        block = int(t // self.wl["traffic"]["rebuild_s"])
        with ctx:
            self._inputs(block)
            before = self.carry
            self.carry, m = self.loop.run(before, self.target, self.ms, 1)
            self._sync()
        self.periods += 1
        self.metrics.append(m)
        if not traced:
            self.records.append((block, before, m, self.carry))
        return 1, "period"

    def warmup(self):
        self.carry = self.loop.warmup(self.carry, self.target, self.ms,
                                      self.wl["traffic"]["warmup_solves"])
        for _ in range(self.wl["warmup_steps"]):
            self.step()
        self.metrics, self.records = [], []

    def counts(self):
        """(periods run since the warm-up, those whose metrics are not
        finite or whose sticky safety flag fell)."""
        bad = 0
        for m in self.metrics:
            ok = bool(m.safe.all())
            for a in m:
                if a.is_floating_point():
                    ok = ok and bool(torch.isfinite(a).all())
            bad += not ok
        return len(self.metrics), bad

    def _sample(self, n):
        """Indices of the n window periods that the check recomputes: the
        first, and `periods` more drawn from the seed among the others."""
        rest = traffic.sample(self.seed, max(n - 1, 0),
                              self.wl["check"]["periods"])
        return [0] + [1 + i for i in rest] if n else []

    def release(self):
        """Keep the sampled periods on the host, then drop the program's
        state."""
        keep = []
        for i in self._sample(len(self.records)):
            block, before, m, after = self.records[i]
            tick = dict(x_des=m.x_des[0], u_des=m.u_des[0],
                        u_last=m.u_last[0], q=m.q_meas[0], v=m.v_meas[0],
                        flags=m.contact_flags[0], x=m.x_opt[0])
            out = dict(cost=m.mpc_cost[0], X=after.base.X_warm,
                       arm_cmd=after.arm_cmd, tau=m.torques[0][:12],
                       q=after.base.plant.q, v=after.base.plant.v,
                       tick=tick)
            keep.append((block, _cpu(_state(before)), _cpu(out)))
        self.records = keep
        self.loop = self.carry = self.target = self.ms = None
        self.metrics = []

    # -- the plain reference ------------------------------------------------

    def control(self):
        """Put the reference in float32 with TF32 products, on the card,
        in the port's place: its own closed loop from the seed's spawn
        fills the records, sampled as the window's are."""
        chk, tr = self.wl["check"], self.wl["traffic"]
        self.loop = self.carry = None
        var, inputs = variant_check.reference(self.cfg, tr, torch.float32,
                                              self.dev)
        rebuild = tr["rebuild_s"]
        seq = []
        prev = settings.tf32(True)
        try:
            with cycle_check.float32_interior_point():
                st = var.start(torch.as_tensor(self.q0), *inputs(0),
                               solves=tr["warmup_solves"])
                for k in range(self.wl["warmup_steps"]
                               + chk["control_periods"]):
                    block = int(k * self.period // rebuild)
                    new, out = var.run(st, *inputs(block))
                    out = dict(out, q=new["q"], v=new["v"])
                    if k >= self.wl["warmup_steps"]:
                        seq.append((block, _cpu(st), _cpu(out)))
                    st = new
        finally:
            settings.tf32(prev)
        self.records = [seq[i] for i in self._sample(len(seq))]

    def readings(self):
        """The numbers the check compares (max over the periods); the
        per-period numbers in `detail`."""
        tr = self.wl["traffic"]
        limit = self.wl["check"]["limits"]["level_gap"]
        jobs = [(self.cfg, tr, block, st, out, limit)
                for block, st, out in self.records]
        workers = self.wl["check"]["workers"] if self.dev.type == "cuda" \
            else 1
        got = variant_check.all_gaps(jobs, workers)
        self.detail = [(j[3]["t"], g) for j, g in zip(jobs, got)]
        if not got:
            return {k: float("nan") for k in variant_check.NUMBERS}
        out = {k: 0.0 for k in variant_check.NUMBERS}
        for g in got:
            for k in variant_check.NUMBERS:
                worst(out, k, g[k])
        return out

    def check(self):
        limits = self.wl["check"]["limits"]
        got = self.readings()
        return {k: {"value": got[k], "limit": limits[k]} for k in limits}

