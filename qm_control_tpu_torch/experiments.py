"""Canonical experiments (port of qm_control_tpu/experiments.py), the
BASELINE.json configs:

  1. standing_ee_hold      - the EE pose held while standing or trotting
                             in place (returned with its TrajectoryLog)
  2. traverse_ee_hold      - cmd_vel locomotion with the EE pose held
  3. ee_tracking           - whole-body planning to a moving EE target
  4. disturbance_rejection - a sustained lateral EE force, with or
                             without the MPC's wrench feedthrough
  5. batched_rollouts      - a domain-randomized fleet of batched solves
  6. mpc_variant_standing  - the QMMpcController variant standing: the
                             MPC-only WBC on the legs, the arm under
                             position PIDs

Configs 1-4 and 6 run the closed loop (MPC + WBC + plant) with the JAX
package's host protocol: chunks of MPC periods, targets re-issued between
chunks, a receding mode-schedule window. Each runs on `device` (default "cuda")
and returns the JAX function's metrics dict.
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
from .ocp.reference import cmd_vel_to_target, target_from_knots
from .parallel.batch import BatchScenario, make_batched_mpc_step
from .runtime.estimator import observation_from_rbd, rbd_state_from_plant
from .runtime.loop import ControlLoop, LoopConfig
from .runtime.mpc_loop import MpcControlLoop
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


def _host(a):
    return a.detach().cpu().numpy()


def _plan_exec_split(model, m):
    """The cycle-end EE error split into planning, |FK(x_des) - ee_ref|,
    and execution, |ee_pos - FK(x_des)| (WBC + plant)."""
    q_des = C.state_to_q(m.x_des[-1])
    p_plan, _ = K.frame_pose(model, K.fk(model, q_des), EE_FRAME)
    p_plan = _host(p_plan)
    ee = _host(m.ee_pos[-1])
    ref = _host(m.ee_ref[-1])
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


def traverse_ee_hold(cfg: Optional[QmConfig] = None, gait: str = "trot",
                     speed: float = -0.03, distance: float = 0.3,
                     max_time: float = 12.0, warmup: int = 25,
                     control_freq: float = 1000.0, delay_s: float = 0.0,
                     cmd_ramp_s: float = 0.5, taper_dist: float = 0.0,
                     stop_gait: str = "", device="cuda") -> dict:
    """Config #2: cmd_vel traverse with the EE pose held fixed in the world
    (the README 30 cm EE-stability experiment). The robot stands (stance)
    until 0.5 s, the EE pose observed then is held, and the base walks at
    `speed` (ramped over cmd_ramp_s, tapered over the last taper_dist
    meters) until it has covered `distance`, when the operator may switch
    to `stop_gait`. Targets are re-issued from the current observation
    every chunk of 0.25 s (cmd_vel_to_target, as the reference's publisher
    node does) and the mode schedule is a receding window. The error
    metrics split into *_walk (up to the goal) and *_after (the hold after
    arrival); the headline ee_pos/ori cover the whole run after 0.6 s."""
    cfg = cfg or _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    loop = ControlLoop(model, info, cfg, _loop_cfg(control_freq, delay_s),
                       device=device)
    dev = loop.device
    ee_hold = None
    target = target_from_knots([0.0, max_time + 5], [s, s], device=dev)
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    gs.insert_template(GAIT_LIBRARY[gait], 0.5)
    horizon = cfg.mpc.time_horizon
    ms = gs.mode_schedule(0.0, horizon + 2.0, device=dev)
    carry = loop.init_carry(q0)
    carry = loop.warmup(carry, target, ms, num_solves=warmup)
    chunk = max(1, int(0.25 * cfg.mpc.mpc_frequency))
    phase = "settle"
    x_start = 0.0
    max_retreat = 0.0   # peak |displacement|: the EE hold can pull the
    # base back, so the end displacement underreports the walk
    worst = {"walk": [0.0] * 4, "after": [0.0] * 4}
    reached = False
    log = TrajectoryLog()
    while float(carry.t) < max_time:
        t_now = float(carry.t)
        rbd = rbd_state_from_plant(model, carry.plant.q, carry.plant.v)
        x_obs = _host(observation_from_rbd(model, info, rbd, carry.last_yaw))
        ee_state = _host(rbd[48:55])
        x_now = float(carry.plant.q[0])
        if phase == "settle" and t_now >= 0.5:
            phase = "walk"
            ee_hold = ee_state.copy()
            x_start = x_now
            t_walk = t_now
        max_retreat = max(max_retreat, abs(x_now - x_start))
        if phase == "walk" and abs(x_now - x_start) >= distance:
            phase = "stop"
            reached = True
            if stop_gait:
                gs.insert_template(GAIT_LIBRARY[stop_gait], t_now + 0.3)
        if phase == "walk":
            # a gamepad stick reaches its deflection over cmd_ramp_s
            ramp = (min(1.0, (t_now - t_walk) / cmd_ramp_s)
                    if cmd_ramp_s > 0 else 1.0)
            if taper_dist > 0:
                remaining = distance - abs(x_now - x_start)
                ramp *= min(1.0, max(0.15, remaining / taper_dist))
            v_cmd = [speed * ramp, 0, 0, 0]
        else:
            v_cmd = [0, 0, 0, 0]
        hold = ee_state.copy() if ee_hold is None else ee_hold.copy()
        target, _ = cmd_vel_to_target(v_cmd, hold, t_now, x_obs, ee_state,
                                      cfg.reference, device=dev)
        ms = gs.mode_schedule(max(0.0, t_now - 0.5), t_now + horizon + 1.0,
                              device=dev)
        carry, m = loop.run(carry, target, ms, num_cycles=chunk, log=log)
        if float(carry.t) > 0.6:
            w = worst["after" if reached else "walk"]
            pe, xe = _plan_exec_split(model, m)
            for i, v in enumerate((float(m.ee_pos_err.max()),
                                   float(m.ee_ori_err.max()), pe, xe)):
                w[i] = max(w[i], v)
        if not bool(m.safe[-1]):
            break
    wj = [max(a, b) for a, b in zip(worst["walk"], worst["after"])]
    return {
        "experiment": f"traverse_ee_hold[{gait}, {speed} m/s]",
        "distance_reached_m": abs(float(carry.plant.q[0]) - x_start),
        "max_displacement_m": max_retreat,
        "ee_pos_err_max_mm": 1e3 * wj[0],
        "ee_ori_err_max_deg": float(np.degrees(wj[1])),
        "ee_pos_err_walk_mm": 1e3 * worst["walk"][0],
        "ee_ori_err_walk_deg": float(np.degrees(worst["walk"][1])),
        "ee_pos_err_after_mm": 1e3 * worst["after"][0],
        "ee_ori_err_after_deg": float(np.degrees(worst["after"][1])),
        "ee_plan_err_max_mm": 1e3 * wj[2],
        "ee_exec_err_max_mm": 1e3 * wj[3],
        "safe": bool(carry.safe),
        "reference_target_mm": 3.5,
        "reference_target_deg": 2.6,
        "cycle_timer": loop.cycle_timer.summary(),
        "log": log,
    }


def ee_tracking(cfg: Optional[QmConfig] = None, duration: float = 4.0,
                amplitude: float = 0.1, period: float = 4.0,
                warmup: int = 25, preview: bool = True,
                target_lead_s: float = 0.0, mrt_policy_lag: int = 1,
                device="cuda") -> dict:
    """Config #3: track a moving EE target (a vertical figure sweep) with
    whole-body planning, standing; the base follows with the mount
    offset. preview=True publishes the future reference as 8 knots over
    the MPC horizon (the reference's TargetTrajectories carry any number
    of knots, EndEffectorConstraint.cpp:82-113); preview=False re-issues
    the instantaneous pose. target_lead_s publishes the reference that
    much earlier (lead compensation). Errors are measured after 1.0 s at
    each chunk's end, against the true (unshifted) reference."""
    cfg = cfg or _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    loop = ControlLoop(model, info, cfg,
                       LoopConfig(mrt_policy_lag=mrt_policy_lag),
                       device=device)
    dev = loop.device
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(
        0.0, duration + 5, device=dev)
    target = target_from_knots([0.0, duration + 5], [s, s], device=dev)
    carry = loop.init_carry(q0)
    carry = loop.warmup(carry, target, ms, num_solves=warmup)
    chunk = max(1, int(0.25 * cfg.mpc.mpc_frequency))
    errs, ori_errs, plan_errs, exec_errs = [], [], [], []

    def ref_state(t):
        """The hold state with the EE swept: y sinusoid, z raised cosine."""
        s_t = s.copy()
        s_t[31] = s[31] + amplitude * np.sin(2 * np.pi * t / period)
        s_t[32] = s[32] + 0.5 * amplitude * (1 - np.cos(2 * np.pi * t
                                                        / period))
        return s_t

    horizon = cfg.mpc.time_horizon
    while float(carry.t) < duration:
        t = float(carry.t)
        if preview:
            # 8 knots: now .. now + horizon + one chunk of slack
            knot_ts = [t + a * (horizon + 0.3) / 7 for a in range(8)]
            target = target_from_knots(
                knot_ts, [ref_state(tt + target_lead_s) for tt in knot_ts],
                device=dev)
        else:
            s_t = ref_state(t + target_lead_s)
            target = target_from_knots([t, t + 0.5, duration + 5],
                                       [s_t, s_t, s_t], device=dev)
        carry, m = loop.run(carry, target, ms, num_cycles=chunk)
        if t > 1.0:
            # true-reference error at the chunk's end (not the led target)
            p_ref_true = ref_state(float(carry.t))[30:33]
            errs.append(float(np.linalg.norm(_host(m.ee_pos[-1])
                                             - p_ref_true)))
            # the orientation reference does not move in this sweep
            ori_errs.append(float(m.ee_ori_err[-1]))
            pe, xe = _plan_exec_split(model, m)
            plan_errs.append(pe)
            exec_errs.append(xe)
    return {
        "experiment": "ee_tracking",
        "ee_pos_err_max_mm": 1e3 * float(np.max(errs)),
        "ee_pos_err_mean_mm": 1e3 * float(np.mean(errs)),
        "ee_ori_err_max_deg": float(np.degrees(np.max(ori_errs))),
        "ee_plan_err_max_mm": 1e3 * float(np.max(plan_errs)),
        "ee_exec_err_max_mm": 1e3 * float(np.max(exec_errs)),
        "safe": bool(carry.safe),
    }


def disturbance_rejection(cfg: Optional[QmConfig] = None,
                          ee_force: float = 20.0,
                          push_velocity: float = 0.0,
                          settle: float = 1.0, hold: float = 1.5,
                          release: float = 1.0, warmup: int = 25,
                          settle_band_mm: float = 5.0,
                          mpc_wrench_feedthrough: bool = True,
                          device="cuda") -> dict:
    """Config #4: an EE force disturbance. After `settle` seconds a
    sustained world force of `ee_force` N (lateral, -y) acts at the arm EE
    for `hold` seconds, then is released for `release` seconds; the WBC
    receives it as a measured input, and with mpc_wrench_feedthrough the
    MPC dynamics too, so the planner braces (beyond the reference, whose
    MPC never sees the wrench). push_velocity adds a lateral base
    velocity impulse (m/s) at the onset. Recovered: safe, finite, the EE
    back within settle_band_mm for the rest of the release window, and an
    excursion under load of at most 120 mm."""
    cfg = cfg or _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    loop = ControlLoop(model, info, cfg, LoopConfig(
        mpc_wrench_feedthrough=mpc_wrench_feedthrough), device=device)
    dev = loop.device
    target = target_from_knots([0.0, 20.0], [s, s], device=dev)
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 20.0,
                                                           device=dev)
    carry = loop.init_carry(q0)
    carry = loop.warmup(carry, target, ms, num_solves=warmup)
    carry, _ = loop.run(carry, target, ms,
                        num_cycles=int(settle * cfg.mpc.mpc_frequency))
    # the disturbance: a sustained EE wrench and a base velocity impulse,
    # as new tensors (the carry's own are never written)
    f32 = dict(dtype=torch.float32, device=dev)
    wrench = torch.tensor([0.0, -ee_force, 0.0, 0.0, 0.0, 0.0], **f32)
    push = torch.zeros(24, **f32)
    push[1] = push_velocity
    carry = carry._replace(plant=carry.plant._replace(
        ee_wrench=wrench, v=carry.plant.v + push))
    carry, m_hold = loop.run(carry, target, ms,
                             num_cycles=int(hold * cfg.mpc.mpc_frequency))
    hold_errs = _host(m_hold.ee_pos_err)
    err_under_load = 1e3 * float(hold_errs[-1])
    excursion_mm = 1e3 * float(np.max(hold_errs))
    carry = carry._replace(plant=carry.plant._replace(
        ee_wrench=torch.zeros(6, **f32)))
    t_release = float(carry.t)
    carry, m = loop.run(carry, target, ms,
                        num_cycles=int(release * cfg.mpc.mpc_frequency))
    y_end = float(carry.plant.q[1])
    # settled: the EE back within settle_band_mm and staying there for
    # the rest of the release window
    rel_errs = 1e3 * _host(m.ee_pos_err)
    inside = rel_errs <= settle_band_mm
    settled_from = None
    for i in range(len(inside)):
        if inside[i:].all():
            settled_from = i
            break
    settling_time_s = (None if settled_from is None
                       else (settled_from + 1) / cfg.mpc.mpc_frequency)
    max_excursion_bound_mm = 120.0   # a 25 N lateral force on a 5.7 kg
    # arm: the MPC leans the whole body into the push
    recovered = (bool(m.safe[-1]) and bool(np.isfinite(y_end))
                 and settling_time_s is not None
                 and excursion_mm <= max_excursion_bound_mm)
    return {
        "experiment": f"disturbance_rejection[{ee_force} N EE force]",
        "recovered": recovered,
        "ee_pos_err_under_load_mm": err_under_load,
        "ee_excursion_max_mm": excursion_mm,
        "ee_excursion_bound_mm": max_excursion_bound_mm,
        "settling_time_s": settling_time_s,
        "settle_band_mm": settle_band_mm,
        "ee_pos_err_end_mm": 1e3 * float(m.ee_pos_err[-1]),
        "lateral_displacement_m": abs(y_end),
        "release_time_s": t_release,
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


def mpc_variant_standing(cfg: Optional[QmConfig] = None,
                         duration: float = 2.0, warmup: int = 25,
                         transient: float = 0.5, device="cuda") -> dict:
    """QMMpcController-variant validation (reference
    QMController.cpp:368-445): the legs driven by the MPC-only WBC's hybrid
    commands (the pivoted cascade), the arm under position PIDs tracking
    integrated MPC joint velocities, 500 Hz ticks of LoopConfig().
    Standing stance: checks that the base holds its height and the arm
    follows the MPC plan."""
    cfg = cfg or _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    loop = MpcControlLoop(model, info, cfg, LoopConfig(), device=device)
    dev = loop.device
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(
        0.0, duration + 5, device=dev)
    target = target_from_knots([0.0, duration + 5], [s, s], device=dev)
    carry = loop.init_carry(q0)
    carry = loop.warmup(carry, target, ms, num_solves=warmup)
    chunk = max(1, int(0.25 * cfg.mpc.mpc_frequency))
    pos_errs, heights, arm_errs, safes = [], [], [], []
    log = TrajectoryLog()
    while float(carry.base.t) < duration:
        carry, m = loop.run(carry, target, ms, chunk, log=log)
        if float(carry.base.t) > transient:
            pos_errs.append(float(m.ee_pos_err[-1]))
            heights.append(float(m.base_height[-1]))
            arm_err = (carry.base.plant.q[18:24] - carry.arm_cmd).abs()
            arm_errs.append(float(arm_err.max()))
        safes.append(bool(m.safe[-1]))
    return {
        "experiment": "mpc_variant_standing",
        "ee_pos_err_max_mm": 1e3 * float(np.max(pos_errs)),
        "base_height_err_max_mm": 1e3 * float(np.max(np.abs(
            np.asarray(heights) - 0.4))),
        "arm_track_err_max_rad": float(np.max(arm_errs)),
        "safe": all(safes),
        "log": log,
    }
