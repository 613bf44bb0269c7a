"""Driver of `runtime.hw.HardwareLoop.tick` with the MPC inline
(`async_mpc=False`, the loop's deterministic single-thread mode) over
`SimHardware`: one robot, one synchronised tick after another, a solve on
every ticks_per_mpc-th tick, the WBC (K1) on every tick, the base hints
taken from the plant, as a real robot's control loop runs it.

Correctness: the plain reference (`reference/hardware.py`, float64 on the
CPU) recomputes ticks sampled from the seed in the window (solve-bearing
and not) from the port's state just before each tick, and the first tick
from the spawn (the start: the estimator's first sample and the cold
solve). Numbers, each the largest over the ticks compared: tau_gap (Nm),
q_gap and v_gap (the plant after the tick), obs_gap (the estimator's
observation), cost_rel and X_gap (the policy of a solve tick).
"""
import contextlib

import torch
from torch.profiler import record_function

from qmbench import settings, traffic
from qmbench.compare import worst

NUMBERS = ("tau_gap", "q_gap", "v_gap", "obs_gap", "cost_rel", "X_gap")


def _loop_state(loop):
    """The port loop's state before a tick, as plain tensors (a tick
    replaces these objects, it does not write into them)."""
    s, p = loop.solver, loop.policy
    return dict(q=loop.hw.state.q, v=loop.hw.state.v,
                anchors=loop.hw.state.anchors,
                offset=loop.est.zyx_offset, latched=loop.est.initialized,
                policy=None if p is None else (p.t_nodes, p.X, p.U, p.modes,
                                               p.cost, p.W),
                W=s._W_prev, X=s._X_prev, t_prev=s._t_prev,
                u_last=loop.wbc._input_last, t=loop.t, k=loop._k)


class _Port:
    """A HardwareLoop of the port over SimHardware with the cell's target
    and mode schedule."""

    def __init__(self, cfg, tr, q0, device):
        from qm_control_tpu_torch import config, models
        from qm_control_tpu_torch.models import centroidal
        from qm_control_tpu_torch.runtime import hw
        qc = settings.qm_config(config, cfg)
        model, info = settings.model_and_info(models, centroidal)
        self.hw = hw.SimHardware(model, q0, substeps=tr["substeps"],
                                 device=device)
        self.loop = hw.HardwareLoop(
            model, info, qc, self.hw, control_freq=tr["control_freq"],
            mpc_freq=tr["mpc_freq"], async_mpc=False, device=device)
        self.cfg, self.tr, self.dev = cfg, tr, device
        self.block = None

    def _inputs(self):
        """The target and the mode schedule over [lo, lo + span_s], lo the
        controller time rounded down to a multiple of rebuild_s: a
        function of the time alone, so that no window, however fast, runs
        off their end."""
        from qm_control_tpu_torch.gaits.library import (GAIT_LIBRARY,
                                                        GaitSchedule)
        from qm_control_tpu_torch.ocp.reference import target_from_knots
        block = int(self.loop.t // self.tr["rebuild_s"])
        if block != self.block:
            tr = self.tr
            lo = block * tr["rebuild_s"]
            times, states = traffic.knots(self.cfg, tr)
            self.target = target_from_knots([lo + t for t in times], states,
                                            device=self.dev)
            self.ms = GaitSchedule(GAIT_LIBRARY[self.cfg["gait"]]) \
                .mode_schedule(lo, lo + tr["span_s"], device=self.dev)
            self.block = block
        return self.target, self.ms

    def solves_next(self):
        L = self.loop
        return L.policy is None or L._k % L.ticks_per_mpc == 0

    def tick(self):
        target, ms = self._inputs()
        res, x_obs = self.loop.tick(target, ms, self.hw.state.q[:3],
                                    self.hw.state.v[:3])
        return res.torques, x_obs

    def state(self):
        return _loop_state(self.loop)


class _Reference:
    """The reference's loop (reference/hardware.py) in `dtype` on
    `device`, from the seed's spawn or from a loop state."""

    def __init__(self, cfg, tr, q0, dtype=torch.float64, device="cpu"):
        from qmbench import reference
        from qmbench.reference.hardware import Loop
        reference.check_config(cfg)
        robot, info = reference.model(dtype, device)
        self.loop = Loop(robot, info, q0, cfg["mpc"]["time_horizon"],
                         cfg["mpc"]["dt"], tr["control_freq"],
                         tr["mpc_freq"], tr["substeps"])
        self.cfg, self.tr, self.dtype, self.dev = cfg, tr, dtype, device
        self.block = None

    def _on(self, a):
        return a.to(device=self.dev, dtype=self.dtype)

    def _inputs(self):
        from qmbench.reference.mpc import Schedule, Target
        block = int(self.loop.t // self.tr["rebuild_s"])
        if block != self.block:
            tr = self.tr
            lo = block * tr["rebuild_s"]
            times, states = traffic.knots(self.cfg, tr)
            self.target = Target([lo + t for t in times], states, self.dtype,
                                 self.dev)
            self.schedule = Schedule(*traffic.gait_events(
                self.cfg, lo + tr["span_s"]))
            self.block = block
        return self.target, self.schedule

    def solves_next(self):
        L = self.loop
        return L.policy is None or L.k % L.every == 0

    def tick(self):
        return self.loop.tick(*self._inputs())

    def load(self, st):
        """Set this loop to a state of _loop_state (the port's)."""
        from qmbench.reference.mpc import Policy
        L, on = self.loop, self._on
        L.plant.q, L.plant.v = on(st["q"]), on(st["v"])
        L.plant.anchors = on(st["anchors"])
        L.offset = on(st["offset"]) if float(st["latched"]) > 0 else None
        L.policy = None if st["policy"] is None else Policy(*[
            on(a) if a.is_floating_point() else a.cpu()
            for a in st["policy"]])
        L.W = None if st["W"] is None else on(st["W"])
        L.X = None if st["X"] is None else on(st["X"])
        L.t_prev, L.u_last = st["t_prev"], on(st["u_last"])
        L.t, L.k = st["t"], st["k"]

    def state(self):
        L = self.loop
        p = L.policy
        one = torch.ones((), dtype=self.dtype)
        return dict(q=L.plant.q, v=L.plant.v, anchors=L.plant.anchors,
                    offset=L.offset if L.offset is not None else
                    torch.zeros(3, dtype=self.dtype), latched=one * (
                        L.offset is not None),
                    policy=None if p is None else (p.t_nodes, p.X, p.U,
                                                   p.modes, p.cost, p.W),
                    W=L.W, X=L.X, t_prev=L.t_prev, u_last=L.u_last, t=L.t,
                    k=L.k)


class Driver:
    def __init__(self, cfg, wl, seed, device):
        from qm_control_tpu_torch.runtime.safety import safety_check
        self.cfg, self.wl, self.seed, self.dev = cfg, wl, seed, device
        self.q0 = traffic.robot_spawn(cfg, seed)
        self.port = _Port(cfg, wl["traffic"], self.q0, device)
        self.safety_check = safety_check
        self.ticks = []          # (state before, tau, x_obs, solved) per tick
        self.bad = torch.zeros((), dtype=torch.int64, device=device)
        self.window_from = 0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def step(self, traced=False):
        side = self.port
        pre = side.state()
        solved = side.solves_next()
        tag = "solve" if solved else "wbc"
        ctx = record_function(f"qmbench.tick.{tag}") if traced \
            else contextlib.nullcontext()
        with ctx:
            tau, x_obs = side.tick()
            ok = torch.isfinite(tau).all() & self.safety_check(
                x_obs.to(torch.float32))
            self.bad += (~ok).to(torch.int64).to(self.bad.device)
            self._sync()
        self.ticks.append((pre, tau, x_obs, solved))
        return 1, tag

    def warmup(self):
        for _ in range(self.wl["warmup_steps"]):
            self.step()
        self.bad.zero_()
        self.window_from = len(self.ticks)

    def counts(self):
        return len(self.ticks) - self.window_from, int(self.bad)

    def release(self):
        self.ticks.append((self.port.state(), None, None, False))
        self.port = None

    # -- the plain reference ------------------------------------------------

    def _compare(self, out, j, tau_r, obs_r, ref):
        """Tick j of the records against the reference's tick (its loop
        `ref` after the tick)."""
        pre, tau, x_obs, solved = self.ticks[j]
        post = self.ticks[j + 1][0]
        L = ref.loop
        cpu = lambda a: a.to("cpu", torch.float64)  # noqa
        tau_gap = (cpu(tau) - tau_r).abs().max()
        v_gap = (cpu(post["v"]) - L.plant.v).abs().max()
        self.detail.append((j, solved, float(tau_gap), float(v_gap)))
        worst(out, "tau_gap", tau_gap)
        worst(out, "obs_gap", (cpu(x_obs) - obs_r).abs().max())
        worst(out, "q_gap", (cpu(post["q"]) - L.plant.q).abs().max())
        worst(out, "v_gap", v_gap)
        if solved:
            cost, X = cpu(post["policy"][4]), cpu(post["policy"][1])
            r = L.policy
            worst(out, "cost_rel", (cost - r.cost).abs()
                  / torch.clamp(r.cost.abs(), min=1.0))
            worst(out, "X_gap", (X - r.X).abs().max())

    def sampled(self):
        """Indices of the window's ticks that the check recomputes."""
        chk = self.wl["check"]
        last = len(self.ticks) - 1          # the appended final state
        idx = range(self.window_from, last)
        solve = [j for j in idx if self.ticks[j][3]]
        other = [j for j in idx if not self.ticks[j][3]]
        pick = [solve[i] for i in traffic.sample(self.seed, len(solve),
                                                 chk["solve_ticks"])]
        pick += [other[i] for i in traffic.sample(self.seed + 1, len(other),
                                                  chk["wbc_ticks"])]
        return sorted(pick)

    def control(self):
        """Put the reference in float32 with TF32 products, on the card,
        in the port's place: its own closed loop from the spawn fills the
        records."""
        side = _Reference(self.cfg, self.wl["traffic"], self.q0,
                          torch.float32, self.dev)
        prev = settings.tf32(True)
        try:
            self.port, self.ticks = side, []
            self.warmup()
            for _ in range(self.wl["check"]["control_ticks"]):
                self.step()
        finally:
            settings.tf32(prev)
        self.release()

    def readings(self):
        out = {k: 0.0 for k in NUMBERS}
        self.detail = []        # (tick, solved, tau gap, v gap) per tick
        with torch.no_grad():
            ref = _Reference(self.cfg, self.wl["traffic"], self.q0)
            # the start: the estimator's first sample and the cold solve
            # from the seed's spawn
            _, obs_r = ref.tick()
            _, _, x_obs, _ = self.ticks[0]
            post = self.ticks[1][0]
            cpu = lambda a: a.to("cpu", torch.float64)  # noqa
            worst(out, "obs_gap", (cpu(x_obs) - obs_r).abs().max())
            worst(out, "cost_rel", (cpu(post["policy"][4])
                                    - ref.loop.policy.cost).abs()
                  / torch.clamp(ref.loop.policy.cost.abs(), min=1.0))
            worst(out, "X_gap", (cpu(post["policy"][1])
                                 - ref.loop.policy.X).abs().max())
            for j in self.sampled():
                ref.load(self.ticks[j][0])
                tau_r, obs_r = ref.tick()
                self._compare(out, j, tau_r, obs_r, ref)
        return out

    def check(self):
        limits = self.wl["check"]["limits"]
        got = self.readings()
        return {k: {"value": got[k], "limit": limits[k]} for k in limits}
