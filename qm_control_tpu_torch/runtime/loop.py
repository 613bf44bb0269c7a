"""Closed-loop control: the real-time tick of qm_control_tpu/runtime/loop.py
(make_cycle's tick scan, :190-229) driven by `ControlLoop.run_ticks`.

Each control tick runs the estimator (rbd_state_from_plant,
observation_from_rbd), MRT policy evaluation of the executed policy,
hierarchical_wbc_update (K1 once per tick), the hybrid joint law
(QMController::updateControlLaw :177-190: legs (posDes, velDes, kp=0, kd,
tau_ff) gated by leg_command_start_time; arm (posDes, 0, kp_arm_wbc,
kd_arm_wbc, tau_ff)), push_command and the plant substeps.

This slice has no MPC stage (make_cycle :164-187, `warmup`, `escape`,
`run` come with the MPC slice). `run_ticks` executes the lagged policy
`carry.policy[0]`, exactly as the ticks of the JAX loop's first cycle do
with mrt_policy_lag=1 (they consume the policy `init_carry` seeded, a
STANCE "hold current state" policy), and it keeps executing it past the
first MPC period. Every MPC period it refreshes the yaw-unwrap reference
from the estimator, as each JAX cycle does. The safety predicate checks
the executed policy's cost (the JAX cycle checks the fresh solve's).
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import QmConfig, WbcGains
from ..gaits.gait import STANCE, contact_flags_from_mode
from ..models import centroidal as C
from ..models.spec import RobotModel
from ..mpc.mpc import MpcPolicy, evaluate_policy
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
    """Per-cycle observability record (filled by the MPC slice's run)."""
    ee_pos_err: torch.Tensor
    ee_ori_err: torch.Tensor
    base_height: torch.Tensor
    mpc_cost: torch.Tensor
    safe: torch.Tensor
    base_pose: torch.Tensor
    ee_pos: torch.Tensor
    ee_ref: torch.Tensor
    feet_pos: torch.Tensor
    forces: torch.Tensor
    torques: torch.Tensor
    x_des: torch.Tensor
    mpc_alpha: torch.Tensor
    mpc_defect: torch.Tensor


class TickOutputs(NamedTuple):
    """Per-tick record of run_ticks (stacked over ticks)."""
    torques: torch.Tensor    # (T, 18) WBC torques
    forces: torch.Tensor     # (T, 12) WBC contact forces
    q: torch.Tensor          # (T, 24) plant q after the tick
    safe: torch.Tensor       # (T,) sticky safety flag


def make_tick(model: RobotModel, info: C.CentroidalInfo,
              loop_cfg: LoopConfig, device, cascade=None):
    """tick(plant, input_last, t, safe, policy, yaw_ref, gains, tau_max)
    -> ((plant, input_last, t, safe), (torques, forces)): one control
    tick, the body of make_cycle's tick scan. cascade: see
    wbc.hierarchical_wbc_update (None = the K1 kernel wrapper)."""
    plant_step = make_plant_step(model, loop_cfg.plant)
    substeps = loop_cfg.substeps_per_tick
    tick_dt = 1.0 / loop_cfg.control_freq
    period = torch.tensor(tick_dt, dtype=torch.float32, device=device)
    leg_rows = torch.cat([torch.ones(12), torch.zeros(6)]).to(device)
    arm_rows = 1.0 - leg_rows

    def tick(plant: PlantState, input_last, t, safe, policy: MpcPolicy,
             yaw_ref, gains: WbcGains, tau_max):
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
            fused_cascade=True, cascade=cascade)
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
        safe = safe & safety_check(x_t, policy.cost)
        return (plant, u_des, t + tick_dt, safe), (wbc.torques, wbc.forces)

    return tick


def _stack_policy(policy: MpcPolicy, lag: int) -> MpcPolicy:
    return MpcPolicy(*[a[None].repeat((lag,) + (1,) * a.dim())
                       for a in policy])


class ControlLoop:
    """Host-side runner of the real-time tick loop."""

    def __init__(self, model: RobotModel, info: C.CentroidalInfo,
                 cfg: QmConfig, loop_cfg: LoopConfig = LoopConfig(),
                 gains: WbcGains = None, device="cuda", cascade=None):
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

    def _lag(self) -> int:
        return max(1, int(self.loop_cfg.mrt_policy_lag))

    def init_carry(self, q0, v0=None) -> CycleCarry:
        """Carry at q0 with the MRT buffer seeded by a STANCE "hold current
        state" policy (JAX loop.py:306-342)."""
        dev, f32 = self.device, torch.float32
        N = self.cfg.mpc.num_nodes
        q0_t = torch.as_tensor(np.asarray(q0), dtype=f32, device=dev)
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

    def run_ticks(self, carry: CycleCarry, num_ticks: int, log=None):
        """Run num_ticks control ticks executing carry.policy[0]; returns
        (carry', TickOutputs). If `log` (a list) is given, one dict of
        device tensors per tick is appended to it."""
        depth = carry.policy.t_nodes.shape[0]
        if depth != self._lag():
            raise ValueError(f"carry.policy stack depth {depth} != "
                             f"max(1, mrt_policy_lag)={self._lag()}")
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
            (plant, input_last, t, safe), (tau, fc) = self._tick(
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
