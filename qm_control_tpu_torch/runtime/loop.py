"""Closed-loop control harness (port of qm_control_tpu/runtime/loop.py):
plant @1 kHz <- WBC every control tick <- policy evaluation <- MPC @100 Hz,
one MPC period per `cycle` call (QMController.cpp:128-190, :309-334).

`make_cycle` builds the period: the estimator pass, one warm-started MPC
solve (`mpc_step`), the MRT lag-stack roll, then `ticks` control ticks,
each the estimator, MRT policy evaluation of the executed policy,
hierarchical_wbc_update (K1 once per tick), the hybrid joint law
(QMController::updateControlLaw :177-190: legs (posDes, velDes, kp=0, kd,
tau_ff) gated by leg_command_start_time; arm (posDes, 0, kp_arm_wbc,
kd_arm_wbc, tau_ff)), push_command and the plant substeps; then the
cycle's metrics. Python loops stand in for the JAX package's lax.scan;
nothing is read back to the host inside a cycle. As in the JAX cycle, the
ticks' safety predicate checks the FRESH solve's cost. With
LoopConfig.mpc_wrench_feedthrough the solve's dynamics carry the plant's
measured EE wrench (the WBC always receives it).

`ControlLoop.run_ticks` runs ticks without an MPC stage: it executes the
lagged policy `carry.policy[0]` (what the ticks of the first cycle do with
mrt_policy_lag=1: the STANCE "hold current state" policy `init_carry`
seeds) and checks safety against that executed policy's cost, refreshing
the yaw-unwrap reference every MPC period. `ControlLoop.escape` is the
basin-escape re-initialization between runs (two deep solves).
"""
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import QmConfig, WbcGains
from ..gaits.gait import STANCE, ModeSchedule, contact_flags_from_mode
from ..models import centroidal as C
from ..models import kinematics as K
from ..models.rotations import quat_distance
from ..models.spec import RobotModel
from ..mpc.mpc import MpcPolicy, evaluate_policy, mpc_step
from ..ocp.problem import make_ocp
from ..ocp.reference import TargetTrajectory, interpolate_ee_pose
from ..solver.sqp import SqpSettings
from ..utils.timers import RepeatedTimer
from ..wbc.wbc import hierarchical_wbc_update
from .estimator import observation_from_rbd, rbd_state_from_plant, rbd_to_qv
from .plant import (HybridCommand, PlantConfig, PlantState, init_plant_state,
                    make_plant_step, push_command)
from .safety import safety_check


class LoopConfig(NamedTuple):
    control_freq: float = 500.0        # WBC ticks per second
    mpc_freq: float = 100.0            # MPC solves per second
    leg_kd: float = 3.0                # QMController.cpp:182
    leg_command_start_time: float = 0.0
    plant: PlantConfig = PlantConfig()
    fused_wbc: Union[bool, str, None] = None   # the WBC cascade. None,
    # True: K1 (the CUDA kernel on the card, its plain version on CPU
    # tensors); "xla": kernels.cascade_exact (plain PyTorch); False: the
    # pivoted cascade (wbc/hoqp.py). The JAX package resolves None to the
    # pivoted cascade off the TPU; the port resolves it to K1
    mpc_wrench_feedthrough: bool = False  # feed the plant's measured EE
    # wrench into the MPC dynamics (disturbance-aware planning, beyond the
    # reference); off by default: one extra EE FK per flow evaluation
    mrt_policy_lag: int = 1   # ticks consume a policy this many MPC
    # periods old (the reference's async MRT semantics)
    delay_compensation_s: float = 0.0   # evaluate the executed policy at
    # t + this lead (the command's application time under a delay line)

    @property
    def ticks_per_cycle(self) -> int:
        return int(round(self.control_freq / self.mpc_freq))

    @property
    def substeps_per_tick(self) -> int:
        return int(round(1.0 / (self.plant.sim_dt * self.control_freq)))


class CycleCarry(NamedTuple):
    plant: PlantState
    W_warm: torch.Tensor        # (N, 30) MPC input warm start
    X_warm: torch.Tensor        # (N+1, 30) MPC state warm start
    input_last: torch.Tensor    # (30,) for the WBC joint-accel difference
    last_yaw: torch.Tensor      # scalar, yaw unwrap memory
    t: torch.Tensor             # controller time
    safe: torch.Tensor          # bool, sticky safety flag
    policy: Optional[MpcPolicy] = None  # MRT policy stack, leading axis =
    # lag depth, index 0 = oldest (the one the ticks execute)


class CycleMetrics(NamedTuple):
    """Per-cycle observability record (the QmVisualizer content of
    reference qm_visualization.cpp:90-189, as tensors)."""
    ee_pos_err: torch.Tensor   # scalar: ||p_ee - p_ref|| at cycle end
    ee_ori_err: torch.Tensor   # scalar: |quat distance| at cycle end
    base_height: torch.Tensor
    mpc_cost: torch.Tensor
    safe: torch.Tensor
    base_pose: torch.Tensor    # (6,) base position + zyx at cycle end
    ee_pos: torch.Tensor       # (3,) measured EE position
    ee_ref: torch.Tensor       # (3,) desired EE position
    feet_pos: torch.Tensor     # (4,3) foot positions
    forces: torch.Tensor       # (12,) WBC contact forces, last tick
    torques: torch.Tensor      # (18,) WBC torques, last tick
    x_des: torch.Tensor        # (30,) policy state at the last tick
    mpc_alpha: torch.Tensor    # accepted SQP line-search step
    mpc_defect: torch.Tensor   # max |shooting defect| of the solution


class TickOutputs(NamedTuple):
    """Per-tick record of run_ticks (stacked over ticks)."""
    torques: torch.Tensor    # (T, 18) WBC torques
    forces: torch.Tensor     # (T, 12) WBC contact forces
    q: torch.Tensor          # (T, 24) plant q after the tick
    safe: torch.Tensor       # (T,) sticky safety flag


def make_tick(model: RobotModel, info: C.CentroidalInfo,
              loop_cfg: LoopConfig, device, cascade=None):
    """tick(plant, input_last, t, safe, policy, yaw_ref, gains, tau_max,
    safety_cost=None) -> ((plant, input_last, t, safe), (torques, forces,
    x_des)): one control tick executing `policy`; safety checks
    `safety_cost` (default: policy.cost). cascade: see
    wbc.hierarchical_wbc_update (None = the cascade loop_cfg.fused_wbc
    names)."""
    plant_step = make_plant_step(model, loop_cfg.plant)
    fused = True if loop_cfg.fused_wbc is None else loop_cfg.fused_wbc
    substeps = loop_cfg.substeps_per_tick
    tick_dt = 1.0 / loop_cfg.control_freq
    period = torch.tensor(tick_dt, dtype=torch.float32, device=device)
    leg_rows = torch.cat([torch.ones(12), torch.zeros(6)]).to(device)
    arm_rows = 1.0 - leg_rows

    def tick(plant: PlantState, input_last, t, safe, policy: MpcPolicy,
             yaw_ref, gains: WbcGains, tau_max, safety_cost=None):
        rbd_t = rbd_state_from_plant(model, plant.q, plant.v)
        x_t = observation_from_rbd(model, info, rbd_t, yaw_ref)
        x_des, u_des, mode = evaluate_policy(
            policy, t + loop_cfg.delay_compensation_s)
        q_meas, v_meas = rbd_to_qv(rbd_t)
        flags = contact_flags_from_mode(mode).to(torch.float32)
        wbc = hierarchical_wbc_update(
            model, info, gains, tau_max, x_des, u_des, input_last,
            q_meas, v_meas, flags, period, t,
            ee_wrench=plant.ee_wrench,     # measured-wrench feedthrough
            fused_cascade=fused, cascade=cascade)
        # hybrid commands (QMController::updateControlLaw :177-190)
        leg_on = (t >= loop_cfg.leg_command_start_time).to(torch.float32)
        kp = gains.kp_arm_wbc * arm_rows
        kd = loop_cfg.leg_kd * leg_on * leg_rows + gains.kd_arm_wbc * arm_rows
        ff = wbc.torques * (leg_on * leg_rows + arm_rows)
        cmd = HybridCommand(pos_des=x_des[12:30],
                            vel_des=u_des[12:30] * (leg_on * leg_rows),
                            kp=kp, kd=kd, ff=ff)
        plant = push_command(plant, cmd)
        for _ in range(substeps):
            plant, _fc = plant_step(plant)
        safe = safe & safety_check(
            x_t, policy.cost if safety_cost is None else safety_cost)
        return ((plant, u_des, t + tick_dt, safe),
                (wbc.torques, wbc.forces, x_des))

    return tick


def _stack_policy(policy: MpcPolicy, lag: int) -> MpcPolicy:
    return MpcPolicy(*[a[None].repeat((lag,) + (1,) * a.dim())
                       for a in policy])


def make_cycle(model: RobotModel, info: C.CentroidalInfo, cfg: QmConfig,
               loop_cfg: LoopConfig, settings: Optional[SqpSettings] = None,
               device="cuda", cascade=None):
    """(cycle, warmup): cycle(carry, target, ms, gains) -> (carry',
    CycleMetrics) runs one MPC period on `device`; warmup(carry, target,
    ms) -> carry' runs one solve without advancing the plant."""
    from .. import resolve_device
    dev = resolve_device(device)
    settings = settings or SqpSettings(num_iterations=cfg.mpc.num_iterations)
    ocp = make_ocp(model, info, cfg)
    tick = make_tick(model, info, loop_cfg, dev, cascade)
    ticks = loop_cfg.ticks_per_cycle
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=dev)
    period = torch.tensor(1.0 / loop_cfg.mpc_freq, dtype=torch.float32,
                          device=dev)
    no_shift = torch.zeros((), dtype=torch.float32, device=dev)
    warm = torch.zeros((), dtype=torch.bool, device=dev)     # cold = False
    lag = int(loop_cfg.mrt_policy_lag)

    def _check_policy_depth(carry):
        """A carry built under another mrt_policy_lag would roll or
        execute the wrong depth: fail loudly instead."""
        if carry.policy is not None:
            _check_depth(carry.policy, max(1, lag))

    def solve(carry, target, ms, shift, ee_wrench=None):
        rbd = rbd_state_from_plant(model, carry.plant.q, carry.plant.v)
        x_obs = observation_from_rbd(model, info, rbd, carry.last_yaw)
        policy = mpc_step(ocp, model, info, cfg, settings, carry.t, x_obs,
                          target, ms, carry.W_warm, carry.X_warm, shift,
                          warm, ee_wrench=ee_wrench)
        return x_obs, policy

    def cycle(carry: CycleCarry, target: TargetTrajectory, ms: ModeSchedule,
              gains: WbcGains):
        _check_policy_depth(carry)
        # --- estimator + MPC solve (the reference's MPC thread) ---
        x_obs, policy = solve(
            carry, target, ms, period,
            carry.plant.ee_wrench if loop_cfg.mpc_wrench_feedthrough
            else None)
        # MRT buffer: the ticks consume a `lag`-period-old policy
        if lag >= 1 and carry.policy is not None:
            exec_policy = MpcPolicy(*[a[0] for a in carry.policy])
            new_stack = MpcPolicy(*[torch.cat([s[1:], n[None]], dim=0)
                                    for s, n in zip(carry.policy, policy)])
        else:
            exec_policy, new_stack = policy, carry.policy
        new_yaw = x_obs[9]

        # --- control ticks (the real-time loop), safety on the fresh cost
        plant, input_last, t, safe = (carry.plant, carry.input_last,
                                      carry.t, carry.safe)
        for _ in range(ticks):
            (plant, input_last, t, safe), (tau, forces, x_des) = tick(
                plant, input_last, t, safe, exec_policy, new_yaw, gains,
                tau_max, safety_cost=policy.cost)

        # --- metrics ---
        rbd_end = rbd_state_from_plant(model, plant.q, plant.v)
        p_ref, q_ref = interpolate_ee_pose(target, t)
        ee_pos = rbd_end[48:51]
        ee_q = torch.cat([rbd_end[54:55], rbd_end[51:54]])
        metrics = CycleMetrics(
            ee_pos_err=torch.linalg.vector_norm(ee_pos - p_ref),
            ee_ori_err=torch.linalg.vector_norm(quat_distance(ee_q, q_ref)),
            base_height=plant.q[2], mpc_cost=policy.cost, safe=safe,
            base_pose=plant.q[:6], ee_pos=ee_pos, ee_ref=p_ref,
            feet_pos=K.contact_positions(model, plant.q),
            forces=forces, torques=tau, x_des=x_des,
            mpc_alpha=policy.alpha, mpc_defect=policy.defect)
        new_carry = CycleCarry(plant=plant, W_warm=policy.W, X_warm=policy.X,
                               input_last=input_last, last_yaw=new_yaw,
                               t=t, safe=safe, policy=new_stack)
        return new_carry, metrics

    def warmup(carry: CycleCarry, target: TargetTrajectory,
               ms: ModeSchedule):
        """One MPC solve without advancing the plant (the reference's
        starting() handshake, QMController.cpp:98-126)."""
        _, policy = solve(carry, target, ms, no_shift)
        return carry._replace(W_warm=policy.W, X_warm=policy.X,
                              policy=_stack_policy(policy, max(1, lag)))

    return cycle, warmup


def _check_depth(policy: MpcPolicy, expected: int):
    depth = policy.t_nodes.shape[0]
    if depth != expected:
        raise ValueError(f"carry.policy stack depth {depth} != "
                         f"max(1, mrt_policy_lag)={expected}; rebuild the "
                         f"carry for this LoopConfig (init_carry/warmup)")


class ControlLoop:
    """Host-side runner: runs MPC cycles (or bare ticks), refreshes targets
    and gaits between runs, collects metrics."""

    def __init__(self, model: RobotModel, info: C.CentroidalInfo,
                 cfg: QmConfig, loop_cfg: LoopConfig = LoopConfig(),
                 gains: WbcGains = None, device="cuda", cascade=None,
                 settings: Optional[SqpSettings] = None):
        from .. import resolve_device
        self.device = resolve_device(device)
        self.model = model
        self.info = info
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.gains = gains or cfg.wbc
        self.tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                                       device=self.device)
        self._tick = make_tick(model, info, loop_cfg, self.device, cascade)
        self._cycle, self._warmup = make_cycle(
            model, info, cfg, loop_cfg, settings, self.device, cascade)
        self._escape = None
        self.escape_costs = None
        self.cycle_timer = RepeatedTimer("control_cycle")

    def _lag(self) -> int:
        return max(1, int(self.loop_cfg.mrt_policy_lag))

    def init_carry(self, q0, v0=None) -> CycleCarry:
        """Carry at q0 with the MRT buffer seeded by a STANCE "hold current
        state" policy (JAX loop.py:306-342)."""
        dev, f32 = self.device, torch.float32
        N = self.cfg.mpc.num_nodes
        q0_t = torch.as_tensor(np.array(q0), dtype=f32, device=dev)
        w0 = C.weight_compensating_input(
            self.info, torch.ones(4, device=dev)).to(f32)
        rbd0 = rbd_state_from_plant(self.model, q0_t,
                                    torch.zeros(24, dtype=f32, device=dev))
        x0 = observation_from_rbd(self.model, self.info, rbd0)
        X0 = x0[None].repeat(N + 1, 1)
        W0 = w0[None].repeat(N, 1)
        hold = MpcPolicy(
            t_nodes=self.cfg.mpc.dt * torch.arange(N + 1, dtype=f32,
                                                   device=dev),
            X=X0, U=w0[None].repeat(N + 1, 1),
            modes=torch.full((N + 1,), STANCE, dtype=torch.int32, device=dev),
            cost=torch.zeros((), dtype=f32, device=dev), W=W0,
            alpha=torch.ones((), dtype=f32, device=dev),
            defect=torch.zeros((), dtype=f32, device=dev))
        return CycleCarry(
            plant=init_plant_state(q0, v0, model=self.model, device=dev),
            W_warm=W0, X_warm=X0,
            input_last=torch.zeros(30, dtype=f32, device=dev),
            last_yaw=torch.tensor(float(np.asarray(q0)[3]), dtype=f32,
                                  device=dev),
            t=torch.zeros((), dtype=f32, device=dev),
            safe=torch.ones((), dtype=torch.bool, device=dev),
            policy=_stack_policy(hold, self._lag()))

    def _build_escape(self):
        """probe(carry, target, ms) -> (cold, warm): two deep solves (12 SQP
        iterations) on identical data, from the QMInitializer start and
        from the carry's warm start."""
        model, info, cfg, dev = self.model, self.info, self.cfg, self.device
        ocp = make_ocp(model, info, cfg)
        deep = SqpSettings(num_iterations=12)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cold_start = torch.ones((), dtype=torch.bool, device=dev)

        def probe(carry: CycleCarry, target, ms):
            rbd = rbd_state_from_plant(model, carry.plant.q, carry.plant.v)
            x_obs = observation_from_rbd(model, info, rbd, carry.last_yaw)
            # the cold solve starts from mpc_step's QMInitializer start
            # whatever warm start it is handed
            return tuple(mpc_step(ocp, model, info, cfg, deep, carry.t,
                                  x_obs, target, ms, carry.W_warm,
                                  carry.X_warm, zero, c)
                         for c in (cold_start, ~cold_start))

        return probe

    def escape(self, carry: CycleCarry, target: TargetTrajectory,
               ms: ModeSchedule, margin: float = 0.02):
        """Basin-escape re-initialization (JAX loop.py:359-391): the
        warm-started real-time iteration can be captured in a locally
        optimal "stay" basin above the walking optimum. Solve deep from
        cold and deep from warm on identical data; adopt the cold
        solution when it beats warm by `margin`, else keep the deepened
        warm one. The comparison is the one host read; the two costs stay
        on the device in self.escape_costs. Returns (carry, escaped:
        bool)."""
        if self._escape is None:
            self._escape = self._build_escape()
        cold, warm = self._escape(carry, target, ms)
        self.escape_costs = (cold.cost, warm.cost)
        # in float64, as the JAX package compares the host floats
        escaped = bool(cold.cost.double()
                       < warm.cost.double() * (1.0 - margin))
        best = cold if escaped else warm
        return carry._replace(W_warm=best.W, X_warm=best.X), escaped

    def warmup(self, carry: CycleCarry, target: TargetTrajectory,
               ms: ModeSchedule, num_solves: int = 20) -> CycleCarry:
        """Converge the MPC warm start before releasing the control loop
        (the reference's starting() initial-policy handshake)."""
        for _ in range(num_solves):
            carry = self._warmup(carry, target, ms)
        return carry

    def run(self, carry: CycleCarry, target: TargetTrajectory,
            ms: ModeSchedule, num_cycles: int, log=None):
        """Run num_cycles MPC periods; returns (carry, stacked metrics).
        With a utils.viz.TrajectoryLog, every cycle's metrics are appended
        to it (copied to the host once per call); each cycle's host wall
        time (its dispatch: the device may still run) goes to
        self.cycle_timer."""
        out = []
        for _ in range(num_cycles):
            with self.cycle_timer:
                carry, m = self._cycle(carry, target, ms, self.gains)
            out.append(m)
        metrics = CycleMetrics(*[torch.stack(xs) for xs in zip(*out)])
        if log is not None:
            # timestamps from carry.t alone: arithmetic with a metric
            # would carry a NaN metric into the time axis
            t_end = float(carry.t)
            host = {k: v.detach().cpu().numpy()
                    for k, v in metrics._asdict().items()}
            for i in range(num_cycles):
                log.append(t_end - (num_cycles - 1 - i)
                           / self.loop_cfg.mpc_freq,
                           **{k: v[i] for k, v in host.items()})
        return carry, metrics

    def run_ticks(self, carry: CycleCarry, num_ticks: int, log=None):
        """Run num_ticks control ticks executing carry.policy[0], with no
        MPC stage; safety checks the executed policy's cost. Returns
        (carry', TickOutputs). If `log` (a list) is given, one dict of
        device tensors per tick is appended to it."""
        _check_depth(carry.policy, self._lag())
        policy = MpcPolicy(*[a[0] for a in carry.policy])
        ticks_per_cycle = self.loop_cfg.ticks_per_cycle
        plant, input_last, t, safe = (carry.plant, carry.input_last,
                                      carry.t, carry.safe)
        last_yaw = carry.last_yaw
        taus, forces, qs, safes = [], [], [], []
        for k in range(num_ticks):
            if k % ticks_per_cycle == 0:
                # the cycle's estimator pass: yaw-unwrap reference
                rbd = rbd_state_from_plant(self.model, plant.q, plant.v)
                last_yaw = observation_from_rbd(self.model, self.info, rbd,
                                                last_yaw)[9]
            (plant, input_last, t, safe), (tau, fc, _) = self._tick(
                plant, input_last, t, safe, policy, last_yaw, self.gains,
                self.tau_max)
            taus.append(tau)
            forces.append(fc)
            qs.append(plant.q)
            safes.append(safe)
            if log is not None:
                log.append(dict(t=t, q=plant.q, torques=tau, forces=fc,
                                safe=safe))
        out = TickOutputs(torch.stack(taus), torch.stack(forces),
                          torch.stack(qs), torch.stack(safes))
        return carry._replace(plant=plant, input_last=input_last,
                              last_yaw=last_yaw, t=t, safe=safe), out
