"""Discrete-time OCP assembly in the reduced input space (port of
qm_control_tpu/ocp/problem.py; reference QMInterface::
setupOptimalControlProblem, QMInterface.cpp:79-142).

The decision input is w, the free coordinates of u after the equality
constraints are eliminated (constraints.py):

    x_{k+1} = F_k(x_k, w_k)          (RK2, zero-order-hold u at the node)
    sum_k dt * L_k(x_k, w_k) + Phi(x_N)

Per-node data (times, contact flags, swing z-velocity references) is
computed for all nodes at once into tensors on the solve's device.
"""
from typing import NamedTuple

import torch

from ..config import QmConfig
from ..gaits.gait import ModeSchedule, contact_flags_at_time
from ..gaits.swing import SwingConfig, swing_z_reference
from ..models import centroidal as C
from ..models._fwd import jacfwd
from ..models.spec import RobotModel
from .constraints import apply_input_param, input_parameterization
from .costs import (ee_residual, make_stage_cost, make_stage_quadratizer,
                    make_stage_quadratizer_parts)
from .reference import TargetTrajectory, interpolate_ee_pose


class OcpParams(NamedTuple):
    """Per-solve data."""
    t_nodes: torch.Tensor        # (N+1,) absolute node times
    contact_flags: torch.Tensor  # (N+1, 4) float 0/1
    swing_zdot: torch.Tensor     # (N+1, 4) swing normal-velocity references
    target: TargetTrajectory     # padded target knots
    x0: torch.Tensor             # (30,) initial state


def make_node_data(ms: ModeSchedule, target: TargetTrajectory, x0,
                   t_start, cfg: QmConfig, dtype=torch.float32) -> OcpParams:
    """Per-node schedule data (the reference's preSolverRun: gait -> mode
    schedule, SwingTrajectoryPlanner update, QMPreComputation queries),
    for all N+1 nodes at once on the schedule's device."""
    N = cfg.mpc.num_nodes
    dev = ms.event_times.device
    t_start = torch.as_tensor(t_start, dtype=dtype, device=dev)
    t_nodes = t_start + cfg.mpc.dt * torch.arange(N + 1, dtype=dtype,
                                                  device=dev)
    horizon_end = t_start + cfg.mpc.time_horizon
    swing_cfg = SwingConfig(
        lift_off_velocity=cfg.swing.lift_off_velocity,
        touch_down_velocity=cfg.swing.touch_down_velocity,
        swing_height=cfg.swing.swing_height,
        touchdown_after_horizon=cfg.swing.touchdown_after_horizon,
        swing_time_scale=cfg.swing.swing_time_scale)
    flags = contact_flags_at_time(ms, t_nodes).to(dtype)       # (N+1, 4)
    zdots = torch.stack([
        swing_z_reference(ms, f, t_nodes, horizon_end, swing_cfg)[1]
        for f in range(4)], dim=-1)                            # (N+1, 4)
    return OcpParams(t_nodes=t_nodes, contact_flags=flags, swing_zdot=zdots,
                     target=target, x0=torch.as_tensor(x0, dtype=dtype))


class Ocp(NamedTuple):
    """Closure bundle for one optimal-control problem (make_ocp)."""
    dynamics: object           # (t, flags, zdot, x, w) -> x_next (RK2)
    stage_cost: object         # (t, flags, zdot, x, w, target) -> dt*L
    final_cost: object         # (t, x, target) -> Phi
    input_of: object           # (t, flags, zdot, x, w) -> u(30)
    stage_quadratize: object   # -> (l, lx, lw, lxx, lww, lwx)
    final_quadratize: object   # -> (l, lx, lxx)
    cost_and_dynamics: object  # fused (cost, x_next)
    stage_linearize: object    # fused (A, B, l, lx, lw, lxx, lww, lwx)


def make_ocp(model: RobotModel, info: C.CentroidalInfo, cfg: QmConfig) -> Ocp:
    """Build the OCP closures (see Ocp fields). One node's data is
    (t, contact_flags (4,), swing_zdot (4,)); the solver vmaps the
    closures over the nodes."""
    stage_l, final_l = make_stage_cost(model, info, cfg)
    stage_q, final_q = make_stage_quadratizer(model, info, cfg)
    stage_q_xu = make_stage_quadratizer_parts(model, info, cfg)
    dt = cfg.mpc.dt

    def input_of(t, flags, zdot, x, w):
        return apply_input_param(
            input_parameterization(model, info, x, flags, zdot), w)

    def flow(x, u, ee_wrench=None):
        return C.flow_map(model, info, x, u, ee_wrench=ee_wrench)

    def rk2(x, u, ee_wrench):
        # RK2 midpoint, zero-order-hold input (sqp.integratorType RK2,
        # task.info:92)
        k1 = flow(x, u, ee_wrench)
        k2 = flow(x + 0.5 * dt * k1, u, ee_wrench)
        return x + dt * k2

    def dynamics(t, flags, zdot, x, w, ee_wrench=None):
        return rk2(x, input_of(t, flags, zdot, x, w), ee_wrench)

    def stage_cost(t, flags, zdot, x, w, target: TargetTrajectory):
        return dt * stage_l(t, x, input_of(t, flags, zdot, x, w), target,
                            flags)

    def cost_and_dynamics(t, flags, zdot, x, w, target: TargetTrajectory,
                          ee_wrench=None):
        """Stage cost and next state from one evaluation of the (FK-heavy)
        input map: the solver's merit needs both."""
        u = input_of(t, flags, zdot, x, w)
        return dt * stage_l(t, x, u, target, flags), rk2(x, u, ee_wrench)

    def final_cost(t, x, target: TargetTrajectory):
        return final_l(t, x, target)

    def stage_quadratize(t, flags, zdot, x, w, target: TargetTrajectory):
        """(l, lx, lw, lxx, lww, lwx): the Gauss-Newton model pulled back
        through u = u0(x) + N(x) w (second derivatives of (u0, N) dropped,
        as OCS2 does when it projects state-input equality constraints)."""
        p = input_parameterization(model, info, x, flags, zdot)
        u = apply_input_param(p, w)
        Ju = jacfwd(lambda xx: apply_input_param(
            input_parameterization(model, info, xx, flags, zdot), w))(x)
        L, Lx, Lu, Lxx, Luu, Lux = stage_q(t, x, u, target, flags)
        return _pull_back(L, Lx, Lu, Lxx, Luu, Lux, Ju, p.N, dt)

    def final_quadratize(t, x, target: TargetTrajectory):
        return final_q(t, x, target)

    def stage_linearize(t, flags, zdot, x, w, target: TargetTrajectory,
                        ee_wrench=None):
        """Dynamics linearization and cost quadratization by one forward-
        mode pass over z = (x, w) of the combined (x_next, u, e_ee) map:
        A, B, du/dx, N = du/dw and the EE-residual Jacobian together
        (60 tangents; the autodiff cross-check of ocp/linearize.py)."""
        p_ref, q_ref = interpolate_ee_pose(target, t)

        def f(zz):
            xx, ww = zz[:30], zz[30:]
            uu = input_of(t, flags, zdot, xx, ww)
            e = ee_residual(model, xx, p_ref, q_ref)
            return torch.cat([rk2(xx, uu, ee_wrench), uu, e])

        from .linearize import value_and_jacfwd
        out, J = value_and_jacfwd(f, torch.cat([x, w]))
        u, e = out[30:60], out[60:]
        A, B = J[:30, :30], J[:30, 30:]
        Ju, N = J[30:60, :30], J[30:60, 30:]
        L, Lx, Lu, Lxx, Luu, Lux = stage_q_xu(t, x, u, target, flags, e,
                                              J[60:, :30])
        return (A, B) + _pull_back(L, Lx, Lu, Lxx, Luu, Lux, Ju, N, dt)

    if cfg.mpc.structured_linearize:
        from .linearize import make_structured_linearize
        stage_linearize = make_structured_linearize(model, info, cfg)

    return Ocp(dynamics, stage_cost, final_cost, input_of,
               stage_quadratize, final_quadratize, cost_and_dynamics,
               stage_linearize)


def _pull_back(L, Lx, Lu, Lxx, Luu, Lux, Ju, N, dt):
    """The (x, u) quadratic model in the (x, w) coordinates, times dt."""
    LuuJu = Luu @ Ju
    lx = Lx + Ju.T @ Lu
    lw = N.T @ Lu
    lxx = Lxx + Ju.T @ Lux + Lux.T @ Ju + Ju.T @ LuuJu
    lww = N.T @ Luu @ N
    lwx = N.T @ (Lux + LuuJu)
    return (dt * L, dt * lx, dt * lw, dt * lxx, dt * lww, dt * lwx)
