"""The plain reference against the port on the CPU, in float64 where the
port runs in it: two independent codes of the same semantics agree to
rounding. The benchmark's own runs hold the port in float32 on the card
against the reference (PERF.md gives those readings)."""
import json
import os

import pytest
import torch

from conftest import BENCH
from qmbench import reference, traffic
from qmbench.reference import robot as R

F64 = torch.float64


def _gap(a, b):
    return float((torch.as_tensor(a, dtype=F64)
                  - torch.as_tensor(b, dtype=F64)).abs().max())


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def port_model():
    from qm_control_tpu_torch.models import centroidal, load_model
    model = load_model()
    return model, centroidal.make_centroidal_info(model)


@pytest.fixture(scope="module")
def ref_model():
    return reference.model()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rigid_body_quantities_match(port_model, ref_model, seed):
    from qm_control_tpu_torch.models import dynamics as D
    from qm_control_tpu_torch.models import kinematics as K
    model, _ = port_model
    robot, _ = ref_model
    g = torch.Generator().manual_seed(seed)
    q = R.nominal_q((0.1, -0.2, 0.38)) + 0.2 * torch.randn(
        24, generator=g, dtype=F64)
    v = torch.randn(24, generator=g, dtype=F64)
    kin = robot.fk(q)
    assert _gap(robot.mass_matrix(q), D.mass_matrix(model, q)) < 1e-12
    assert _gap(robot.bias(q, v), D.nonlinear_effects(model, q, v)) < 1e-11
    assert _gap(robot.momentum_matrix(q),
                D.centroidal_momentum_matrix(model, q)) < 1e-12
    assert _gap(robot.feet(q), K.contact_positions(model, q)) < 1e-14
    assert _gap(robot.frame_jacobian(kin, R.EE),
                K.frame_jacobian(model, q, R.EE)) < 1e-14


def test_centroidal_constants_match(port_model, ref_model):
    """The port computes them in float32: they agree to its rounding."""
    _, info = port_model
    _, ci = ref_model
    assert _gap(ci.r_com, info.r_com_base) < 1e-7
    assert _gap(ci.I_com, info.I_com_base) < 1e-6


@pytest.mark.parametrize("zyx", [(0.3, -0.2, 0.5), (3.0, 0.1, 0.2),
                                 (-2.9, -0.3, -3.1), (0.1, 1.4, 3.0)])
def test_rotations_match(zyx):
    from qm_control_tpu_torch.models import rotations as P
    z = torch.tensor(zyx, dtype=F64)
    Rm = R.euler_zyx_to_R(z)
    assert _gap(Rm, P.euler_zyx_to_R(z)) < 1e-15
    assert _gap(R.euler_rate_matrix(z),
                P.euler_zyx_rate_to_omega_world_matrix(z)) < 1e-15
    assert _gap(R.R_to_quat(Rm), P.R_to_quat(Rm)) < 1e-14
    assert _gap(R.so3_log(Rm), P.so3_log(Rm)) < 1e-12


def test_mpc_solve_matches(ref_model):
    """One warm-started trot solve at a short horizon (0.12 s of 0.04 s
    nodes): the port in float32 against the reference in float64."""
    from qm_control_tpu_torch import config, models
    from qm_control_tpu_torch.gaits.gait import mode_schedule_from_lists
    from qm_control_tpu_torch.models import centroidal
    from qm_control_tpu_torch.mpc.mpc import mpc_step
    from qm_control_tpu_torch.ocp.problem import make_ocp
    from qm_control_tpu_torch.ocp.reference import target_from_knots
    from qm_control_tpu_torch.solver.sqp import SqpSettings
    from qmbench import settings
    from qmbench.reference.mpc import Mpc, Schedule, Target
    cfg = _cfg("fleet_trot")
    cfg["mpc"].update(time_horizon=0.12, dt=0.04)
    tr = {"batch": 3, "span_s": 10.0}
    qc = settings.qm_config(config, cfg)
    model, info = settings.model_and_info(models, centroidal)
    x, x0 = traffic.fleet_state(cfg, tr, 11, "cpu")
    times, states = traffic.knots(cfg, tr)
    events, modes = traffic.gait_events(cfg, 1.0)
    ms = mode_schedule_from_lists(events, modes, device="cpu")
    N = qc.mpc.num_nodes
    W = torch.zeros(N, 30)
    X = x0[None].expand(N + 1, 30).clone()
    p = mpc_step(make_ocp(model, info, qc), model, info, qc,
                 SqpSettings(num_iterations=1), torch.tensor(0.0), x[1],
                 target_from_knots(times, states, device="cpu"), ms, W, X,
                 torch.tensor(0.01), torch.tensor(False))
    robot, ci = ref_model
    r = Mpc(robot, ci, 0.12, 0.04).solve(
        0.0, x[1].to(F64), Target(times, states, F64, "cpu"),
        Schedule(events, modes), W.to(F64), X.to(F64), 0.01)
    assert abs(float(p.cost) - float(r.cost)) / float(r.cost) < 1e-4
    assert _gap(p.X, r.X) < 1e-4
    assert _gap(p.W, r.W) < 0.05
    assert _gap(p.U, r.U) < 0.05


def test_wbc_matches_the_port_in_float64(port_model, ref_model):
    """The WBC's three levels and the cascade's torques on a standing
    stack, the port's plain cascade in float64 against the reference."""
    from qm_control_tpu_torch.config import WbcGains
    from qm_control_tpu_torch.kernels.hoqp_fused import cascade_plain
    from qm_control_tpu_torch.wbc.wbc import wbc_stack
    from qmbench.reference.mpc import Ocp
    from qmbench.reference.wbc import (cascade, desired, levels, measured,
                                       torques)
    model, info = port_model
    robot, ci = ref_model
    x, _ = traffic.standing(_cfg("robot_hw_stance"))
    x = torch.as_tensor(x, dtype=F64)
    g = torch.Generator().manual_seed(3)
    q = x[6:30] + 0.01 * torch.randn(24, generator=g, dtype=F64)
    v = 0.1 * torch.randn(24, generator=g, dtype=F64)
    u = torch.zeros(30, dtype=F64)
    u[2:12:3] = 9.81 * robot.total_mass / 4
    u_last = u.clone()
    u_last[12:] = 0.01
    flags = torch.ones(4, dtype=F64)
    gains = WbcGains(arm_settling_time=0.0)
    tau_max = torch.as_tensor(model.joint_effort, dtype=F64)
    m, (t0, t1, t2) = wbc_stack(model, info, gains, tau_max, x, u, u_last,
                                q, v, flags, torch.tensor(0.002, dtype=F64),
                                torch.tensor(0.0, dtype=F64))
    mr = measured(robot, q, v, flags)
    d = desired(robot, Ocp(robot, ci, 3, 0.04), x, u, u_last, 0.002)
    d["u_des"] = u
    L0, L1, L2 = levels(mr, d, robot.effort)
    for a, b in ((t0.A, L0[0]), (t0.D, L0[2]), (t1.A, L1[0]),
                 (t2.A, L2[0])):
        assert _gap(a, b) < 1e-10
    for a, b in ((t0.b, L0[1]), (t0.f, L0[3]), (t1.b, L1[1]),
                 (t2.b, L2[1])):
        assert _gap(a, b) < 1e-4        # the port's constants are float32
    tau_p = torques(mr, cascade_plain(t0, t1, t2, qp_iters=60))
    tau_r = torques(mr, cascade(L0, L1, L2))
    assert _gap(tau_p, tau_r) < 0.1
