"""The QMMpcController variant's closed loop (port of
qm_control_tpu/runtime/mpc_loop.py; reference QMController.cpp:368-445,
class QMMpcController): the MPC-only WBC drives the legs, the arm is
under position control fed integrated MPC joint velocities.

  - legs: hybrid joint commands (posDes, velDes, kp = 0, kd = 3, tau_ff)
    with torques from hierarchical_mpc_wbc_update (no arm/EE tasks,
    :405-409);
  - arm: the simulator's JointPositionController PIDs
    (position_control.yaml: p = 5000 / d = 8 on joints 1-3, p = 500 /
    d = 0.2 on joints 4-6) tracking a command integrated from the MPC
    solution at 100 Hz: cmd_j = state(24 + j) + velDes(12 + j) / 100
    (:438-443);
  - the arm and leg states both come from the same plant.

One MPC period per `cycle` call, as runtime.loop.make_cycle: the
estimator pass, one warm-started solve whose FRESH policy the ticks
execute (no MRT lag stack, as in the JAX module), then the ticks, each
the estimator, policy evaluation, the MPC-only WBC (the pivoted cascade
by default, as in JAX, through the graph runner "hoqp" of
wbc.pivoted_runner: on the card a cycle maker's second cascade captures
one CUDA graph per level and later ones replay them; K1 with
fused_wbc=True, eager), the hybrid law and the plant substeps. Nothing
is read back to the host inside a cycle. The ranges and counters are
runtime.loop's: `loop.tick` around each tick, `loop.estimate` around
each estimator pass, `tick_count` one per tick and `cycle_count` one
per call.
"""
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..config import QmConfig, WbcGains
from ..gaits.gait import ModeSchedule, contact_flags_from_mode
from ..models import centroidal as C
from ..models import kinematics as K
from ..models.rotations import quat_distance
from ..models.spec import RobotModel
from ..mpc.mpc import evaluate_policy, mpc_step
from ..ocp.problem import make_ocp
from ..ocp.reference import TargetTrajectory, interpolate_ee_pose
from ..solver.sqp import SqpSettings
from ..wbc.wbc import hierarchical_mpc_wbc_update, pivoted_runner
from . import loop as L
from .estimator import observation_from_rbd, rbd_state_from_plant, rbd_to_qv
from .loop import ControlLoop, CycleCarry, CycleMetrics, LoopConfig
from .plant import HybridCommand, make_plant_step, push_command
from .safety import safety_check

# the simulator's position-controller PIDs (position_control.yaml)
ARM_POS_KP = torch.tensor([5000., 5000., 5000., 500., 500., 500.])
ARM_POS_KD = torch.tensor([8., 8., 8., 0.2, 0.2, 0.2])
ARM_CMD_PERIOD = 1.0 / 100.0     # arm_control_loop_hz_ (:436)


# a period's CycleMetrics, then the last tick's MPC-only WBC: its inputs
# beside x_des (u_des, u_last (30,), q_meas, v_meas (24,), contact_flags
# (4,)) and the cascade's solution x_opt (36,), from which the tick's
# levels can be rebuilt and its cascade judged
MpcCycleMetrics = NamedTuple("MpcCycleMetrics", [
    *CycleMetrics.__annotations__.items(),
    *[(k, torch.Tensor) for k in ("u_des", "u_last", "q_meas", "v_meas",
                                  "contact_flags", "x_opt")]])


class MpcCycleCarry(NamedTuple):
    base: CycleCarry
    arm_cmd: torch.Tensor        # (6,) integrated arm position command


def make_mpc_cycle(model: RobotModel, info: C.CentroidalInfo, cfg: QmConfig,
                   loop_cfg: LoopConfig,
                   settings: Optional[SqpSettings] = None,
                   fused_wbc: bool = False, device="cuda"):
    """cycle(carry: MpcCycleCarry, target, ms, gains) -> (carry',
    MpcCycleMetrics): one QMMpcController period on `device`. fused_wbc:
    False (the pivoted cascade, wbc/hoqp.py) or True (K1)."""
    from .. import resolve_device
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    settings = settings or SqpSettings(num_iterations=cfg.mpc.num_iterations)
    ocp = make_ocp(model, info, cfg)
    plant_step = make_plant_step(model, loop_cfg.plant)
    ticks = loop_cfg.ticks_per_cycle
    substeps = loop_cfg.substeps_per_tick
    tick_dt = 1.0 / loop_cfg.control_freq
    tau_max = torch.as_tensor(model.joint_effort, **f32)
    period = torch.tensor(tick_dt, **f32)
    shift = torch.tensor(1.0 / loop_cfg.mpc_freq, **f32)
    warm = torch.zeros((), dtype=torch.bool, device=dev)     # cold = False
    zeros6 = torch.zeros(6, **f32)
    # legs: kp = 0, kd = leg_kd (:429-431); arm: the position PIDs
    kp = torch.cat([torch.zeros(12, **f32), ARM_POS_KP.to(dev)])
    kd = torch.cat([loop_cfg.leg_kd * torch.ones(12, **f32),
                    ARM_POS_KD.to(dev)])
    # the ticks' levels are single and one shape every tick (contact
    # masking is by bounds): one key of the runner
    cascade = None if fused_wbc else pivoted_runner()

    def cycle(carry: MpcCycleCarry, target: TargetTrajectory,
              ms: ModeSchedule, gains: WbcGains):
        L.cycle_count += 1
        cb = carry.base
        with record_function(L.ESTIMATE_SPAN):
            rbd = rbd_state_from_plant(model, cb.plant.q, cb.plant.v)
            x_obs = observation_from_rbd(model, info, rbd, cb.last_yaw)
        policy = mpc_step(ocp, model, info, cfg, settings, cb.t, x_obs,
                          target, ms, cb.W_warm, cb.X_warm, shift, warm)
        new_yaw = x_obs[9]
        # the arm command at the MPC rate (:436-443): the integrated MPC
        # joint velocity on top of the current MPC state
        x_now, u_now, _ = evaluate_policy(policy, cb.t)
        arm_cmd = x_now[24:30] + u_now[24:30] * ARM_CMD_PERIOD

        plant, input_last, t, safe = (cb.plant, cb.input_last, cb.t,
                                      cb.safe)
        for _ in range(ticks):
            L.tick_count += 1
            with record_function(L.TICK_SPAN):
                with record_function(L.ESTIMATE_SPAN):
                    rbd_t = rbd_state_from_plant(model, plant.q, plant.v)
                    x_t = observation_from_rbd(model, info, rbd_t, new_yaw)
                x_des, u_des, mode = evaluate_policy(policy, t)
                q_meas, v_meas = rbd_to_qv(rbd_t)
                flags = contact_flags_from_mode(mode).to(torch.float32)
                u_last = input_last
                wbc = hierarchical_mpc_wbc_update(
                    model, info, gains, tau_max, x_des, u_des, input_last,
                    q_meas, v_meas, flags, period, ee_wrench=plant.ee_wrench,
                    fused_cascade=fused_wbc, cascade=cascade)
                plant = push_command(plant, HybridCommand(
                    pos_des=torch.cat([x_des[12:24], arm_cmd]),
                    vel_des=torch.cat([u_des[12:24], zeros6]), kp=kp, kd=kd,
                    ff=torch.cat([wbc.torques[:12], zeros6])))
                for _ in range(substeps):
                    plant, _fc = plant_step(plant)
                safe = safe & safety_check(x_t, policy.cost)
                input_last, t = u_des, t + tick_dt

        rbd_end = rbd_state_from_plant(model, plant.q, plant.v)
        p_ref, q_ref = interpolate_ee_pose(target, t)
        ee_pos = rbd_end[48:51]
        ee_q = torch.cat([rbd_end[54:55], rbd_end[51:54]])
        metrics = MpcCycleMetrics(
            ee_pos_err=torch.linalg.vector_norm(ee_pos - p_ref),
            ee_ori_err=torch.linalg.vector_norm(quat_distance(ee_q, q_ref)),
            base_height=plant.q[2], mpc_cost=policy.cost, safe=safe,
            base_pose=plant.q[:6], ee_pos=ee_pos, ee_ref=p_ref,
            feet_pos=K.contact_positions(model, plant.q),
            forces=wbc.forces, torques=wbc.torques, x_des=x_des,
            mpc_alpha=policy.alpha, mpc_defect=policy.defect,
            u_des=u_des, u_last=u_last, q_meas=q_meas, v_meas=v_meas,
            contact_flags=flags, x_opt=wbc.x_opt)
        base = CycleCarry(plant=plant, W_warm=policy.W, X_warm=policy.X,
                          input_last=input_last, last_yaw=new_yaw, t=t,
                          safe=safe)
        return MpcCycleCarry(base=base, arm_cmd=arm_cmd), metrics

    return cycle


class MpcControlLoop:
    """Host-side driver of the QMMpcController variant (mirrors
    runtime.loop.ControlLoop, whose carry and warm-up it reuses)."""

    def __init__(self, model: RobotModel, info: C.CentroidalInfo,
                 cfg: QmConfig, loop_cfg: LoopConfig = LoopConfig(),
                 gains: WbcGains = None,
                 settings: Optional[SqpSettings] = None, device="cuda"):
        self.model = model
        self.info = info
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.gains = gains or cfg.wbc
        self._inner = ControlLoop(model, info, cfg, loop_cfg, gains,
                                  device=device, settings=settings)
        self.device = self._inner.device
        self._cycle = make_mpc_cycle(model, info, cfg, loop_cfg, settings,
                                     device=self.device)

    def init_carry(self, q0, v0=None) -> MpcCycleCarry:
        base = self._inner.init_carry(q0, v0)
        return MpcCycleCarry(base=base, arm_cmd=base.plant.q[18:24])

    def warmup(self, carry: MpcCycleCarry, target, ms,
               num_solves: int = 20) -> MpcCycleCarry:
        return carry._replace(base=self._inner.warmup(carry.base, target,
                                                      ms, num_solves))

    def run(self, carry: MpcCycleCarry, target, ms, num_cycles: int,
            log=None):
        """Run num_cycles MPC periods; returns (carry, stacked metrics).
        With a utils.viz.TrajectoryLog, every cycle's metrics are appended
        to it (copied to the host once per call)."""
        out = []
        for _ in range(num_cycles):
            carry, m = self._cycle(carry, target, ms, self.gains)
            out.append(m)
        metrics = MpcCycleMetrics(*[torch.stack(xs) for xs in zip(*out)])
        if log is not None:
            t_end = float(carry.base.t)
            host = {k: v.detach().cpu().numpy()
                    for k, v in metrics._asdict().items()}
            for i in range(num_cycles):
                log.append(t_end - (num_cycles - 1 - i)
                           / self.loop_cfg.mpc_freq,
                           **{k: v[i] for k, v in host.items()})
        return carry, metrics
