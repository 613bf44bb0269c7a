"""Driver of `parallel.make_batched_mpc_step`: a fleet of B scenarios, one
batched warm-started MPC step after another (bench.py's semantics: t and
x are held, every step starts from the last step's policy, so each step
is the same work: one SQP iteration with its line-search candidates).

Correctness: on a sample of scenarios drawn from the seed (the first and
the last always), the plain reference (`reference/mpc.py`, one scenario
at a time, float64 on the CPU) recomputes (a) the first step from the
benchmark's inputs alone and (b) the last step of the run from the
port's previous policy for that scenario. Numbers: cost_rel (|cost -
ref| / max(1, |ref|)), X_gap and W_gap (max |.|), the largest over the
sample and both steps.
"""
import contextlib

import torch
from torch.profiler import record_function

from qmbench import settings, traffic
from qmbench.compare import worst


def _tile(a, B):
    return a[None].expand(B, *a.shape).clone()


class Driver:
    def __init__(self, cfg, wl, seed, device):
        from qm_control_tpu_torch import config as port_config
        from qm_control_tpu_torch import models
        from qm_control_tpu_torch.gaits.library import (GAIT_LIBRARY,
                                                        GaitSchedule)
        from qm_control_tpu_torch.models import centroidal
        from qm_control_tpu_torch.ocp.reference import target_from_knots
        from qm_control_tpu_torch.parallel import (BatchScenario,
                                                   make_batched_mpc_step)
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, device
        tr = wl["traffic"]
        self.B = B = tr["batch"]
        qc = settings.qm_config(port_config, cfg)
        model, info = settings.model_and_info(models, centroidal)
        # the inputs, made by the benchmark; the port builds its own
        # structures from them
        self.x, x0 = traffic.fleet_state(cfg, tr, seed, device)
        times, states = traffic.knots(cfg, tr)
        target = target_from_knots(times, states, device=device)
        ms = GaitSchedule(GAIT_LIBRARY[cfg["gait"]]).mode_schedule(
            0.0, tr["span_s"], device=device)
        N = qc.mpc.num_nodes
        self.batch = BatchScenario(
            t=torch.zeros(B, device=device), x=self.x,
            target=type(target)(*[_tile(a, B) for a in target]),
            ms=type(ms)(*[_tile(a, B) for a in ms]),
            W_warm=torch.zeros(B, N, 30, device=device),
            X_warm=_tile(x0[None].expand(N + 1, 30), B))
        self.x0 = x0
        self.step_fn = make_batched_mpc_step(model, info, qc)
        self.rows = traffic.sample(seed, B, wl["check"]["sample"],
                                   first=(0, B - 1))
        self.idx = torch.as_tensor(self.rows, device=device)
        self.first = self.prev = self.last = None
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.steps = 0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, traced=False):
        ctx = record_function("qmbench.fleet_step") if traced \
            else contextlib.nullcontext()
        with ctx:
            self.batch, pol = self.step_fn(self.batch)
            rec = tuple(a.index_select(0, self.idx)
                        for a in (pol.cost, pol.X, pol.W))
            ok = (torch.isfinite(pol.cost)
                  & torch.isfinite(pol.X).flatten(1).all(1)
                  & torch.isfinite(pol.W).flatten(1).all(1))
            self.bad += (~ok).sum()
            self._sync()
        self.prev, self.last = self.last, rec
        if self.first is None:
            self.first = rec
        self.steps += 1
        return self.B, "step"

    def warmup(self):
        for _ in range(self.wl["warmup_steps"]):
            self.step()
        self.bad.zero_()
        self.steps = 0

    def counts(self):
        return self.B * self.steps, int(self.bad)

    def release(self):
        self.batch = self.step_fn = None

    # -- the plain reference ------------------------------------------------

    def _reference(self, dtype=torch.float64, device="cpu"):
        """solve(row, W_warm=None, X_warm=None) -> (cost, X, W) of the
        reference's MPC on scenario `row`, from the benchmark's inputs."""
        from qmbench import reference
        from qmbench.reference.mpc import Mpc, Schedule, Target
        cfg, tr = self.cfg, self.wl["traffic"]
        reference.check_config(cfg)
        robot, info = reference.model(dtype, device)
        mpc = Mpc(robot, info, cfg["mpc"]["time_horizon"], cfg["mpc"]["dt"])
        times, states = traffic.knots(cfg, tr)
        target = Target(times, states, dtype, device)
        schedule = Schedule(*traffic.gait_events(cfg, tr["span_s"]))
        shift = 1.0 / cfg["mpc"]["mpc_frequency"]
        on = lambda a: a.to(device=device, dtype=dtype)  # noqa
        x0 = on(self.x0)

        def solve(row, W_warm=None, X_warm=None):
            if W_warm is None:          # the first step: bench.py's start
                W_warm = torch.zeros(mpc.N, 30, dtype=dtype, device=device)
                X_warm = x0[None].expand(mpc.N + 1, 30)
            p = mpc.solve(0.0, on(self.x[row]), target, schedule,
                          on(W_warm), on(X_warm), shift)
            return p.cost, p.X, p.W
        return solve

    def control(self):
        """Put the reference in float32 with TF32 products, on the card,
        in the port's place: the first and the last records of the sample
        become its first step and its second step from that."""
        solve = self._reference(torch.float32, self.dev)
        prev = settings.tf32(True)
        try:
            firsts, lasts = [], []
            for row in self.rows:
                f = solve(row)
                firsts.append(f)
                lasts.append(solve(row, f[2], f[1]))
        finally:
            settings.tf32(prev)
        stack = lambda rs: tuple(torch.stack(z) for z in zip(*rs))  # noqa
        self.first = self.prev = stack(firsts)
        self.last = stack(lasts)

    def readings(self):
        """The numbers the check compares (max over sample and steps)."""
        solve = self._reference()
        out = dict(cost_rel=0.0, X_gap=0.0, W_gap=0.0)
        with torch.no_grad():
            for j, row in enumerate(self.rows):
                pairs = [(self.first, solve(row)),
                         (self.last, solve(row, self.prev[2][j],
                                           self.prev[1][j]))]
                for rec, ref in pairs:
                    c, X, W = (a[j].to("cpu", torch.float64) for a in rec)
                    rc, rX, rW = ref
                    worst(out, "cost_rel", (c - rc).abs()
                          / torch.clamp(rc.abs(), min=1.0))
                    worst(out, "X_gap", (X - rX).abs().max())
                    worst(out, "W_gap", (W - rW).abs().max())
        return out

    def check(self):
        limits = self.wl["check"]["limits"]
        got = self.readings()
        return {k: {"value": got[k], "limit": limits[k]} for k in limits}
