"""Canonical experiments (port of qm_control_tpu/experiments.py). Ported:
config #1, `standing_ee_hold` (the EE pose held while standing or
trotting in place, closed loop: MPC + WBC + plant, returned with its
TrajectoryLog), and config #5, `batched_rollouts` (a domain-randomized
fleet of batched MPC solves). Each runs on `device` (default "cuda") and
returns a metrics dict.
"""
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config import MpcConfig, QmConfig
from .gaits.library import GAIT_LIBRARY, GaitSchedule
from .models import centroidal as C
from .models import kinematics as K
from .models import load_model
from .models.spec import EE_FRAME, default_q
from .ocp.reference import target_from_knots
from .parallel.batch import BatchScenario, make_batched_mpc_step
from .runtime.estimator import rbd_state_from_plant
from .runtime.loop import ControlLoop, LoopConfig
from .runtime.plant import PlantConfig, delay_steps_for
from .utils.viz import TrajectoryLog


def _default_cfg(horizon=1.0, dt=0.015):
    cfg = QmConfig().with_(mpc=MpcConfig(time_horizon=horizon, dt=dt,
                                         num_iterations=1))
    return cfg.with_(wbc=dataclasses.replace(cfg.wbc, arm_settling_time=0.0))


def _loop_cfg(control_freq: float = 1000.0, delay_s: float = 0.0):
    """The accuracy experiments' loop: 1 kHz ticks (the reference's
    mrtDesiredFrequency, task.info:147). delay_s injects an actuation
    delay (the reference's Gazebo sim runs 0.009 s) and evaluates the
    executed policy at the command's application time."""
    plant = PlantConfig()
    if delay_s > 0:
        plant = plant._replace(
            delay_steps=delay_steps_for(delay_s, push_freq=control_freq))
    return LoopConfig(control_freq=control_freq, plant=plant,
                      delay_compensation_s=delay_s)


def _plan_exec_split(model, m):
    """The cycle-end EE error split into planning, |FK(x_des) - ee_ref|,
    and execution, |ee_pos - FK(x_des)| (WBC + plant)."""
    q_des = C.state_to_q(m.x_des[-1])
    p_plan, _ = K.frame_pose(model, K.fk(model, q_des), EE_FRAME)
    p_plan = p_plan.detach().cpu().numpy()
    ee = m.ee_pos[-1].detach().cpu().numpy()
    ref = m.ee_ref[-1].detach().cpu().numpy()
    return (float(np.linalg.norm(p_plan - ref)),
            float(np.linalg.norm(ee - p_plan)))


def _standing_setup(cfg):
    """(model, info, q0, s): the spawn at 0.38 m and the 37-dim target."""
    model = load_model()
    info = C.make_centroidal_info(model)
    q0 = np.asarray(default_q(base_pos=(0, 0, 0.38)), dtype=np.float32)
    s = np.zeros(37)
    s[6:30] = q0
    s[8] = 0.4
    s[30:33] = [0.52, 0.09, 0.78]
    s[33:37] = [0.5, -0.5, 0.5, -0.5]
    return model, info, q0, s


def standing_ee_hold(cfg: Optional[QmConfig] = None, gait: str = "trot",
                     duration: float = 4.0, warmup: int = 25,
                     transient: float = 1.0, control_freq: float = 1000.0,
                     delay_s: float = 0.0, ee_offset_x: float = 0.0,
                     mrt_policy_lag: int = 1, gains=None,
                     device="cuda") -> dict:
    """Config #1: EE pose hold while standing / trotting in place.

    The reference's protocol: settle in STANCE for 0.5 s (the gait is
    inserted at 0.5 s), capture the EE's settled pose as the hold target,
    then run `duration` seconds in chunks of 0.25 s with a receding mode
    schedule. ee_offset_x holds the EE that far in front of its settled
    pose (extended-arm trot in place), re-anchoring the base target at the
    current base every chunk."""
    cfg = cfg or _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    loop = ControlLoop(model, info, cfg,
                       _loop_cfg(control_freq, delay_s)._replace(
                           mrt_policy_lag=mrt_policy_lag), gains=gains,
                       device=device)
    dev = loop.device
    target = target_from_knots([0.0, duration + 5], [s, s], device=dev)
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    gs.insert_template(GAIT_LIBRARY[gait], 0.5)
    horizon_w = cfg.mpc.time_horizon + 2.0
    ms = gs.mode_schedule(0.0, horizon_w, device=dev)
    carry = loop.init_carry(q0)
    carry = loop.warmup(carry, target, ms, num_solves=warmup)
    carry, _ = loop.run(carry, target, ms,
                        num_cycles=max(1, int(0.5 * cfg.mpc.mpc_frequency)))
    rbd0 = rbd_state_from_plant(model, carry.plant.q, carry.plant.v)
    s = s.copy()
    s[30:37] = rbd0[48:55].detach().cpu().numpy()
    s[30] += ee_offset_x
    target = target_from_knots([float(carry.t), duration + 5], [s, s],
                               device=dev)
    pos_errs, ori_errs, safes = [], [], []
    plan_errs, exec_errs = [], []
    log = TrajectoryLog()
    cycles = int(duration * cfg.mpc.mpc_frequency)
    chunk = max(1, int(0.25 * cfg.mpc.mpc_frequency))
    for _ in range(cycles // chunk):
        if ee_offset_x:
            s_t = s.copy()
            s_t[6:8] = carry.plant.q[:2].detach().cpu().numpy()
            target = target_from_knots(
                [float(carry.t), duration + 5], [s_t, s_t], device=dev)
        # receding mode-schedule window (a fixed one would overflow
        # MAX_EVENTS on long runs)
        ms = gs.mode_schedule(max(0.0, float(carry.t) - 0.5),
                              float(carry.t) + horizon_w, device=dev)
        carry, m = loop.run(carry, target, ms, num_cycles=chunk, log=log)
        if float(carry.t) > transient:
            pos_errs.append(float(m.ee_pos_err[-1]))
            ori_errs.append(float(m.ee_ori_err[-1]))
            pe, xe = _plan_exec_split(model, m)
            plan_errs.append(pe)
            exec_errs.append(xe)
        safes.append(bool(m.safe[-1]))
    arrays = log.as_arrays()
    tarr = arrays["t"] - arrays["t"][0]
    mlate = tarr > transient
    rolls = np.degrees(arrays["base_pose"][mlate, 5]) if mlate.any() else \
        np.zeros(1)
    return {
        "experiment": f"standing_ee_hold[{gait}]"
                      + (f"[ext{ee_offset_x:g}]" if ee_offset_x else ""),
        "ee_pos_err_max_mm": 1e3 * float(np.max(pos_errs)),
        "ee_pos_err_mean_mm": 1e3 * float(np.mean(pos_errs)),
        "ee_ori_err_max_deg": float(np.degrees(np.max(ori_errs))),
        "ee_plan_err_max_mm": 1e3 * float(np.max(plan_errs)),
        "ee_exec_err_max_mm": 1e3 * float(np.max(exec_errs)),
        "roll_pp_deg": float(rolls.max() - rolls.min()),
        "safe": all(safes),
        "reference_target_mm": 3.5,
        "reference_target_deg": 2.6,
        "cycle_timer": loop.cycle_timer.summary(),
        "log": log,
    }


def batched_rollouts(cfg: Optional[QmConfig] = None, batch: int = 64,
                     num_steps: int = 5, seed: int = 0,
                     device="cuda") -> dict:
    """Config #5: domain-randomized scenario fleet — batched MPC solves
    over randomized initial states (the gain-tuning workload). The
    randomisation is the JAX package's, drawn from
    np.random.default_rng(seed)."""
    dev = resolve_device(device)
    cfg = cfg or _default_cfg(horizon=0.5, dt=0.025)
    model, info, q0, s = _standing_setup(cfg)
    rng = np.random.default_rng(seed)
    N = cfg.mpc.num_nodes
    B = batch

    def tile(a):
        return a[None].expand(B, *a.shape).clone()

    target = target_from_knots([0.0, 10.0], [s, s], device=dev)
    ms = GaitSchedule(GAIT_LIBRARY["trot"]).mode_schedule(0.0, 10.0,
                                                          device=dev)
    x0 = torch.as_tensor(s[:30], dtype=torch.float32, device=dev)
    x0[8] = 0.38
    noise = rng.normal(0, 0.02, (B, 30)) * ([1] * 12 + [0.3] * 18)
    b = BatchScenario(
        t=torch.zeros(B, dtype=torch.float32, device=dev),
        x=tile(x0) + torch.as_tensor(noise, dtype=torch.float32, device=dev),
        target=type(target)(*map(tile, target)),
        ms=type(ms)(*map(tile, ms)),
        W_warm=torch.zeros(B, N, 30, dtype=torch.float32, device=dev),
        X_warm=tile(x0[None].expand(N + 1, 30)))
    step = make_batched_mpc_step(model, info, cfg)
    for _ in range(num_steps):
        b, policy = step(b)
    costs = policy.cost.detach().cpu().numpy()
    return {
        "experiment": f"batched_rollouts[B={B}]",
        "finite_fraction": float(np.isfinite(costs).mean()),
        "cost_mean": float(np.nanmean(costs)),
        "cost_p95": float(np.nanpercentile(costs, 95)),
    }
