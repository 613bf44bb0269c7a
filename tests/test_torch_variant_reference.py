"""The port's MPC-only controller period (runtime/mpc_loop.py
make_mpc_cycle, through MpcControlLoop) against the benchmark's plain
reference of that period (qmbench/reference/variant.py, float64), and the
pivoted cascade's frozen operation count (qmbench/counts/hoqp.py).

The benchmark's driver (qmbench/drivers/mpc_variant.py) runs the port on
the CPU at the cut horizon of the benchmark's CPU tests (0.12 s of 0.04 s
nodes) with the robot, the MPC-only stack (30/56, 18, 12 rows), the
500 Hz ticks, the two plant substeps and the arm's position PIDs whole:
2 starting solves, 2 periods past the landing from the spawn, then 2
periods that the reference recomputes from the port's carry at their
start, each on every number of the benchmark's check, in stance (the
cell's gait) and in trot (where the swing feet's task acts). Four faults
planted in the port's period, in trot, each fail at least one tolerance:
the ticks executing the policy of the period before, the arm's position
and velocity gains swapped, the swing task's weight 1 instead of 100,
and the cascade's last level dropped. A period's metrics return the
last tick's WBC inputs and solution that the driver's level check reads.
"""
import dataclasses
import importlib
import json
import os

import pytest
import torch

from qmbench import variant_check
from qmbench.counts import hoqp as HC
from qm_control_tpu_torch.runtime import mpc_loop as ML
from qm_control_tpu_torch.wbc import hoqp as H
from qm_control_tpu_torch.wbc import wbc as W

MV = importlib.import_module("qmbench.drivers.mpc_variant")
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "qmbench")
SEED = 2 ** 31 + 11
TRAFFIC = {"span_s": 10.0, "rebuild_s": 5.0, "warmup_solves": 2}
PERIODS = 2

# Each tolerance sits between what the port reads here (float32 against
# float64, up to the figure in brackets over both gaits) and what the
# faults read, with a reason for its size:
TOL = {
    # one SQP iteration of the same problem in float32 [7.5e-7; the
    # lagged policy reads 0.85]
    "cost_rel": 1e-4,
    # the fresh plan's states: float32 rounding of the Riccati sweep
    # [4.5e-7]
    "X_gap": 1e-5,
    # the arm command, the plan's arm state plus its velocity over 10 ms
    # [1.3e-7 rad]
    "arm_cmd_gap": 1e-5,
    # the last tick's leg torques: the port's cascade runs 10 interior-
    # point iterations, the reference solves each level to convergence
    # [2.0e-3 Nm; the faults read 0.46 Nm and more]
    "tau_gap": 0.05,
    # the plant after 5 ticks of 2 substeps: float32 torques and
    # integration [5.7e-7; the faults 2.8e-4 and more]
    "q_gap": 1e-5,
    # [9.9e-5 rad/s; the faults 0.05 and more]
    "v_gap": 2e-3,
    # the last tick's levels: the port's solution on the reference's
    # levels against the reference's own solution, the objectives'
    # differences over max(|o|, 1) [1.6e-3, level 0 after 10 interior-
    # point iterations; the dropped level reads 76]
    "level_gap": 1e-2,
}


def _config(gait):
    with open(os.path.join(BENCH, "configs", "robot_variant_stance.json")) \
            as fh:
        cfg = json.load(fh)
    cfg["mpc"].update(time_horizon=0.12, dt=0.04)
    if gait == "trot":
        cfg.update(name="robot_variant_trot", gait="trot", gait_cycle={
            "modes": ["LF_RH", "RF_LH"], "switching_times": [0.0, 0.35,
                                                             0.7]})
    return cfg


def _fault(mp, kind):
    """Plant `kind` in the port's period; returns a function that plants
    what has to wait for the driver's loop."""
    if kind == "lag":               # the policy of the period before
        real, held = ML.mpc_step, []

        def lagged(*a, **k):
            held.append(real(*a, **k))
            return held[-2] if len(held) > 1 else held[-1]
        mp.setattr(ML, "mpc_step", lagged)
    elif kind == "arm_gains":       # the arm's kp and kd swapped
        real = ML.push_command

        def swapped(plant, cmd):
            kp = torch.cat([cmd.kp[:12], cmd.kd[12:]])
            kd = torch.cat([cmd.kd[:12], cmd.kp[12:]])
            return real(plant, cmd._replace(kp=kp, kd=kd))
        mp.setattr(ML, "push_command", swapped)
    elif kind == "drop_level":      # the cascade's last level dropped
        mp.setattr(W, "_pivoted", lambda t0, t1, t2: H.hoqp_solve([t0, t1]))
    elif kind == "swing_weight":    # the swing task's weight 1, not 100
        return lambda loop: setattr(loop, "gains", dataclasses.replace(
            loop.gains, swing_task_weight=1.0))
    return lambda loop: None


def _gaps(gait, kind):
    """[gaps of each recomputed period] of the port with `kind` planted."""
    cfg = _config(gait)
    wl = {"traffic": TRAFFIC, "warmup_steps": 2,
          "check": {"periods": PERIODS, "limits": TOL}}
    with pytest.MonkeyPatch.context() as mp:
        after = _fault(mp, kind)
        drv = MV.Driver(cfg, wl, SEED, torch.device("cpu"))
        after(drv.loop)
        drv.warmup()
        for _ in range(PERIODS):
            drv.step()
        drv.release()
    return [variant_check.gaps((cfg, TRAFFIC, block, st, out,
                                TOL["level_gap"]))
            for block, st, out in drv.records]


@pytest.fixture(scope="module")
def readings():
    torch.set_num_threads(1)
    got = {(g, "port"): _gaps(g, "port") for g in ("stance", "trot")}
    for kind in ("lag", "arm_gains", "swing_weight", "drop_level"):
        got[("trot", kind)] = _gaps("trot", kind)
    return got


@pytest.mark.parametrize("gait", ["stance", "trot"])
@pytest.mark.parametrize("number", list(TOL))
def test_port_period_matches_the_reference(readings, gait, number):
    got = [g[number] for g in readings[(gait, "port")]]
    assert len(got) == PERIODS
    assert max(got) < TOL[number], got


@pytest.mark.parametrize("kind", ["lag", "arm_gains", "swing_weight",
                                  "drop_level"])
def test_planted_fault_fails_a_tolerance(readings, kind):
    got = readings[("trot", kind)]
    assert any(not g[k] < TOL[k] for g in got for k in TOL), got


def test_metrics_hold_the_last_ticks_wbc():
    """A period's metrics (MpcCycleMetrics) return its last tick's WBC
    inputs and solution, as the driver's level check reads them: the
    MPC-only stack rebuilt from those inputs and solved by the pivoted
    cascade gives that solution and the period's torques bit for bit."""
    from qm_control_tpu_torch.wbc.tasks import recover_torques
    drv = MV.Driver(_config("stance"), {"traffic": TRAFFIC,
                                        "warmup_steps": 0,
                                        "check": {"periods": 0}},
                    SEED, torch.device("cpu"))
    drv.warmup()
    drv.step()
    _, _, m, _ = drv.records[0]
    lp = drv.loop
    m_, stack = W.mpc_wbc_stack(
        lp.model, lp.info, lp.gains,
        torch.as_tensor(lp.model.joint_effort, dtype=torch.float32),
        m.x_des[0], m.u_des[0], m.u_last[0], m.q_meas[0], m.v_meas[0],
        m.contact_flags[0], torch.tensor(1.0 / lp.loop_cfg.control_freq),
        ee_wrench=torch.zeros(6))
    x = H.hoqp_solve(list(stack))
    assert torch.equal(x, m.x_opt[0])
    assert torch.equal(recover_torques(m_, x, torch.zeros(6)), m.torques[0])


def test_hoqp_work_of_one_level_by_hand():
    """Level 1 of the MPC-only stack (18 task rows, the 56 inequality rows
    of level 0 carried, 36 unknowns, 10 interior-point iterations, its
    null-space update used by level 2), counted by hand."""
    nx, ma, m, it = 36, 18, 56, 10
    az = 2 * ma * nx * nx                  # A Z
    gram = 2 * ma * nx * nx                # Az' Az
    cz = 2 * ma * nx + 2 * ma * nx         # r = A x - b, Az' r
    carried = 2 * m * nx * nx + 2 * m * nx  # D Z, D x
    hmv = 2 * (2 * ma * nx)                # Az' (Az z)
    start = (2 * nx ** 3 // 3 + 2 * nx * nx) + 2 * m * nx + hmv \
        + 2 * (2 * m * nx)
    newton = 5 * (2 * nx * nx) + 2 * (2 * m * nx)
    per_it = hmv + 2 * (2 * m * nx) + 2 * m * nx * nx + 2 * nx ** 3 \
        + 2 * newton + hmv + 2 * (2 * m * nx)
    update = 2 * nx * nx                   # x += Z z
    proj = 2 * ma * ma * nx + (2 * ma ** 3 // 3 + 2 * ma * ma * nx) \
        + 2 * nx * nx * ma + 2 * nx ** 3   # Az Az', its solve, Az' inv, Z P
    want = az + gram + cz + carried + start + it * per_it + update + proj
    assert HC.level_work(1, ma, m, it, last=False) == want == 3_504_816
    flops, nbytes = HC.hoqp_work(30, 56, 18, 12, 10)
    assert flops == sum(HC.level_work(k, a, 56, 10, k == 2)
                        for k, a in enumerate((30, 18, 12)))
    assert nbytes == 4 * ((30 + 18 + 12 + 56) * 37 + 36)
