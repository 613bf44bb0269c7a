"""Driver of `parallel.make_batched_cycle`: a fleet of B closed-loop
rollouts, one batched control period after another (each the MPC solve,
then the period's WBC ticks over the plant, every scenario at once), as
the fleet's users run the whole controller to tune its gains. A step is
one period of the B scenarios; the rate counts B solves, each with its
ticks, per step.

Set-up: the port's cycle and the controller's start (one solve that does
not advance the plant, `ControlLoop._warmup` under vmap) from the spawn
heights of the seed, then the cell's warm-up periods: three, which also
pass the landing from the spawn, where float32 and float64 part about
twice a tick (on an H100 the period at 20 ms read 100 times the gaps of
the later ones).

Correctness, after the window, from what the timed path produced: on a
sample of scenarios drawn from the seed (the first and the last always)
and of periods (the window's first, and `cycles` more drawn from the
seed among those with no gait event within `clear_s` before the period
or inside it), the plain reference (`reference/cycle.py`, float64 on the
CPU, a pool of `workers` processes on the card's machine;
`cycle_check.py`) recomputes the period from the port's carry at its
start. The driver
keeps a reference to those carries; the cycle replaces a carry's tensors
and never writes into them, so keeping one costs no copy. Numbers, each
the largest over the sample: cost_rel and X_gap (the fresh policy), tau_gap
(Nm, the last tick's WBC torques), q_gap and v_gap (the plant after the
period).
"""
import contextlib
import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from qmbench import cycle_check, settings, traffic


def _tile(a, B):
    return a[None].expand(B, *a.shape).clone()


def spawn(cfg, B, seed, device):
    """(B, 24) plant positions: the spawn with the seed's base heights."""
    x0, _ = traffic.standing(cfg)
    q = _tile(torch.as_tensor(x0[6:30], device=device), B)
    q[:, 2] += traffic.heights(seed, B, cfg["height_spread"], device)
    return q


def loop_config(cfg, loop_module, plant_module):
    """The port's LoopConfig of the configuration."""
    return loop_module.LoopConfig(
        control_freq=cfg["control_freq"],
        mpc_freq=cfg["mpc"]["mpc_frequency"], leg_kd=cfg["leg_kd"],
        plant=plant_module.PlantConfig(**cfg["plant"]),
        mrt_policy_lag=cfg["mrt_policy_lag"])


def wbc_gains(cfg, qc):
    """The port's WbcGains of the configuration (per-axis gains given once
    for the three axes)."""
    g = dict(cfg["wbc_gains"])
    for k in ("kp_ee_linear", "kd_ee_linear", "kp_ee_angular",
              "kd_ee_angular"):
        g[k] = (g[k],) * 3
    return dataclasses.replace(qc.wbc, **g)


def _state(carry, i):
    """Scenario i of a port carry as the reference's period state."""
    p = carry.plant
    pol = carry.policy
    return dict(q=p.q[i], v=p.v[i], anchors=p.anchors[i], W=carry.W_warm[i],
                X=carry.X_warm[i], u_last=carry.input_last[i],
                yaw=carry.last_yaw[i], t=float(carry.t[i]),
                policy=tuple(a[i][0] for a in (pol.t_nodes, pol.X, pol.U,
                                               pol.modes, pol.cost, pol.W)))


def _outputs(m, after, i):
    """What scenario i's period produced, as the check compares it: the
    fresh policy's cost and X, the last tick's torques, the plant after."""
    return dict(cost=m.mpc_cost[i], X=after.X_warm[i], tau=m.torques[i],
                q=after.plant.q[i], v=after.plant.v[i])


def _cpu(d):
    return {k: (tuple(a.cpu() for a in v) if isinstance(v, tuple)
                else v.cpu() if torch.is_tensor(v) else v)
            for k, v in d.items()}


class _Picker:
    """Reservoir sampling, from the seed, of k of the periods offered one
    after another: each kept with the same chance whatever their number,
    and at most k held at any time."""

    def __init__(self, seed, k):
        self.rng = np.random.default_rng(int(seed) % (2 ** 63) + 2)
        self.k, self.n, self.kept = k, 0, []

    def offer(self, item):
        self.n += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        r = int(self.rng.integers(self.n))
        if r < self.k:
            self.kept[r] = item


class Driver:
    def __init__(self, cfg, wl, seed, device):
        from qm_control_tpu_torch import config as port_config
        from qm_control_tpu_torch import models
        from qm_control_tpu_torch.models import centroidal
        from qm_control_tpu_torch.parallel import make_batched_cycle
        from qm_control_tpu_torch.runtime import loop as L
        from qm_control_tpu_torch.runtime import plant as P
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, device
        tr, chk = wl["traffic"], wl["check"]
        self.B = B = tr["batch"]
        qc = settings.qm_config(port_config, cfg)
        model, info = settings.model_and_info(models, centroidal)
        lc = loop_config(cfg, L, P)
        self.gains = wbc_gains(cfg, qc)
        self.period = 1.0 / cfg["mpc"]["mpc_frequency"]
        self.vcycle, make_carries = make_batched_cycle(
            model, info, qc, lc, gains=self.gains, device=device)
        start = L.ControlLoop(model, info, qc, lc, gains=self.gains,
                              device=device)
        carries = make_carries(traffic.standing(cfg)[0][6:30], B)
        q = spawn(cfg, B, seed, device)
        carries = carries._replace(plant=carries.plant._replace(q=q))
        self.block = None
        self._inputs(0)
        self.carries = torch.func.vmap(start._warmup)(carries, self.target,
                                                      self.ms)
        self.rows = traffic.sample(seed, B, chk["sample"], first=(0, B - 1))
        self.cycles = 0           # periods run since the start
        self.metrics = []         # every period's metrics since the warm-up
        self._reset_sample()

    def _reset_sample(self):
        self.first = None
        self.picker = _Picker(self.seed, self.wl["check"]["cycles"])

    def _inputs(self, block):
        """The port's batched target and mode schedule of `block`."""
        if block == self.block:
            return
        from qm_control_tpu_torch.gaits.library import (GAIT_LIBRARY,
                                                        GaitSchedule)
        from qm_control_tpu_torch.ocp.reference import target_from_knots
        tr = self.wl["traffic"]
        lo, times, states = cycle_check.inputs_at(self.cfg, tr, block)
        target = target_from_knots(times, states, device=self.dev)
        ms = GaitSchedule(GAIT_LIBRARY[self.cfg["gait"]]).mode_schedule(
            lo, lo + tr["span_s"], device=self.dev)
        self.target = type(target)(*[_tile(a, self.B) for a in target])
        self.ms = type(ms)(*[_tile(a, self.B) for a in ms])
        self.block = block

    def _offer(self, rec, t):
        """Sample the record of the period at t: the window's first, then
        among those clear of gait events."""
        if self.first is None:
            self.first = rec
        elif self._clear(t):
            self.picker.offer(rec)

    def _clear(self, t):
        """No gait event within clear_s before the period at t or in it."""
        lo = t - self.wl["check"]["clear_s"] - 1e-9
        hi = t + self.period + 1e-9
        events, _ = traffic.gait_events(self.cfg, hi)
        return not any(lo <= e <= hi for e in events)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, traced=False):
        ctx = record_function("qmbench.cycle") if traced \
            else contextlib.nullcontext()
        t = self.cycles * self.period
        block = int(t // self.wl["traffic"]["rebuild_s"])
        with ctx:
            self._inputs(block)
            before = self.carries
            self.carries, m = self.vcycle(before, self.target, self.ms,
                                          self.gains)
            self._sync()
        self.cycles += 1
        self.metrics.append(m)
        if not traced:
            self._offer((block, before, m, self.carries), t)
        return self.B, "cycle"

    def warmup(self):
        for _ in range(self.wl["warmup_steps"]):
            self.step()
        self.metrics = []
        self._reset_sample()

    def counts(self):
        """(scenario-periods run since the warm-up, those whose metrics are
        not finite or whose sticky safety flag fell)."""
        bad = 0
        for m in self.metrics:
            ok = m.safe.clone()
            for a in m:
                if a.is_floating_point():
                    ok &= torch.isfinite(a).reshape(self.B, -1).all(1)
            bad += int((~ok).sum())
        return self.B * len(self.metrics), bad

    def release(self):
        """Keep the sampled periods' scenarios on the host, then drop the
        program's state."""
        recs = [] if self.first is None else [self.first]
        self.records = []
        for block, before, m, after in recs + self.picker.kept:
            ins = {i: _cpu(_state(before, i)) for i in self.rows}
            outs = {i: _cpu(_outputs(m, after, i)) for i in self.rows}
            self.records.append((block, ins, outs))
        self.carries = self.vcycle = self.target = self.ms = None
        self.first, self.picker.kept, self.metrics = None, [], []

    # -- the plain reference ------------------------------------------------

    def control(self):
        """Put the reference in float32 with TF32 products, on the card,
        in the port's place: each sampled scenario's own closed loop from
        its spawn fills the records, sampled as the window's are."""
        chk = self.wl["check"]
        cyc, inputs = cycle_check.reference(self.cfg, self.wl["traffic"],
                                            torch.float32, self.dev)
        q0 = spawn(self.cfg, self.B, self.seed, "cpu")
        rebuild = self.wl["traffic"]["rebuild_s"]
        runs = {}
        prev = settings.tf32(True)
        try:
            with cycle_check.float32_interior_point():
                for i in self.rows[:chk["control_rows"]]:
                    st = cyc.start(q0[i], *inputs(0))
                    seq = []
                    for k in range(self.wl["warmup_steps"]
                                   + chk["control_cycles"]):
                        block = int(k * self.period // rebuild)
                        new, out = cyc.run(st, *inputs(block))
                        out = dict(out, q=new["q"], v=new["v"])
                        seq.append((block, _cpu(st), _cpu(out)))
                        st = new
                    runs[i] = seq
        finally:
            settings.tf32(prev)
        self._reset_sample()
        for k in range(self.wl["warmup_steps"], len(runs[self.rows[0]])):
            block = runs[self.rows[0]][k][0]
            self._offer((block, {i: r[k][1] for i, r in runs.items()},
                         {i: r[k][2] for i, r in runs.items()}),
                        k * self.period)
        self.records = [self.first] + self.picker.kept

    def readings(self):
        """The numbers the check compares (max over the sample); the
        pairs in `detail`."""
        tr = self.wl["traffic"]
        jobs = [(self.cfg, tr, block, ins[i], outs[i])
                for block, ins, outs in self.records for i in ins]
        workers = self.wl["check"]["workers"] if self.dev.type == "cuda" \
            else 1
        got = cycle_check.all_gaps(jobs, workers)
        self.detail = [(j[3]["t"], g) for j, g in zip(jobs, got)]
        return cycle_check.largest(got)

    def check(self):
        limits = self.wl["check"]["limits"]
        got = self.readings()
        return {k: {"value": got[k], "limit": limits[k]} for k in limits}
