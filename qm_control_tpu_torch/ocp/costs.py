"""OCP cost stack (port of qm_control_tpu/ocp/costs.py; the reference's
cost/constraint assembly, qm_interface/src/QMInterface.cpp:96-131):

  baseTrackingCost   0.5 dx'Q dx + 0.5 du'R du, du against the gravity-
                     compensating input; R's leg-joint-velocity block
                     weights FOOT velocity relative to the base through the
                     stance Jacobian at the nominal configuration
                     (QMInterface::initializeInputCostWeight, :274-299)
  endEffector        quadratic penalty on [p_ee - p_ref; quatDistance]
                     (EndEffectorConstraint.cpp:14-113, mu 2000/1000)
  armJointLimits     relaxed-barrier box on arm joint positions (state) and
                     velocities (input) (QMInterface.cpp:177-259)
  frictionCone       relaxed barrier on mu*Fz - sqrt(Fx^2+Fy^2+reg), per
                     stance foot (OCS2 FrictionConeConstraint, reg = 25)

Every function works on one (t, x, u) and is functional, so the solver
vmaps it over the nodes; mode-dependent terms are float masks.
"""
import numpy as np
import torch
from torch.func import grad

from ..config import CostConfig, FrictionConfig, JointLimitsConfig, QmConfig
from ..models import centroidal as C
from ..models import chainfk
from ..models import kinematics as K
from ..models._const import const
from ..models._fwd import jacfwd
from ..models.rotations import R_to_quat, quat_distance
from ..models.smallmat import mtm_unrolled, mtv_unrolled
from ..models.spec import NUM_BASE, RobotModel, default_q
from .reference import TargetTrajectory, interpolate_ee_pose, interpolate_state

FRICTION_CONE_REGULARIZATION = 25.0   # OCS2 FrictionConeConstraint default


def quadratic_penalty(h, mu):
    """OCS2 QuadraticPenalty: 0.5 * mu * h^2."""
    return 0.5 * mu * h * h


def relaxed_barrier_penalty(h, mu, delta):
    """OCS2 RelaxedBarrierPenalty: -mu ln(h) for h > delta, quadratic
    extension below (C2 at h = delta). The log takes max(h, delta), so the
    branch not taken gives no NaN gradient through torch.where."""
    safe_h = torch.clamp(h, min=delta)
    log_branch = -mu * torch.log(safe_h)
    quad_branch = mu * (-np.log(delta) + 0.5 * ((h - 2.0 * delta) / delta) ** 2
                        - 0.5)
    return torch.where(h > delta, log_branch, quad_branch)


def input_cost_weight(model: RobotModel, cost_cfg: CostConfig,
                      q_nominal=None) -> np.ndarray:
    """(30,30) R with the leg-joint-velocity block base2feetJac' R_task
    base2feetJac (reference QMInterface.cpp:274-299). base2feetJac rows:
    feet (LF, RF, LH, RH); columns: the 12 leg joints in joint order.
    Runs once at construction, on the CPU."""
    if q_nominal is None:
        q_nominal = default_q(base_pos=(0, 0, 0.4))
    q = torch.as_tensor(np.asarray(q_nominal), dtype=torch.float32)
    J = K.stacked_contact_jacobian(model, q).numpy()          # (12, 24)
    base2feet = J[:, NUM_BASE:NUM_BASE + 12]
    R = np.diag(np.asarray(cost_cfg.r_diag)) * cost_cfg.r_scaling
    R_fv = R[12:24, 12:24]
    R = R.copy()
    R[12:24, 12:24] = base2feet.T @ R_fv @ base2feet
    return R


def tracking_cost(x, u, x_ref30, u_ref, Q_diag, R_full):
    """0.5 dx'Q dx + 0.5 du'R du (the EE tail of the target is ee_cost's)."""
    dx = x - x_ref30
    du = u - u_ref
    return 0.5 * torch.sum(Q_diag * dx * dx) + 0.5 * du @ (R_full @ du)


def ee_pose(model: RobotModel, q):
    """(p_ee, R_ee) via the base->arm chain only (models/chainfk.py)."""
    return chainfk.ee_pose(model, q)


def ee_cost(model: RobotModel, x, p_ref, q_ref_wxyz, mu_pos, mu_ori):
    """Quadratic penalty on the 6-dim EE pose error (reference
    EndEffectorConstraint + QuadraticPenalty)."""
    p_ee, R_ee = ee_pose(model, C.state_to_q(x))
    e_pos = p_ee - p_ref
    e_ori = quat_distance(R_to_quat(R_ee), q_ref_wxyz)
    return (torch.sum(quadratic_penalty(e_pos, mu_pos))
            + torch.sum(quadratic_penalty(e_ori, mu_ori)))


def friction_cone_cost(u, contact_flags, fcfg: FrictionConfig):
    """Relaxed-barrier friction cone, masked by contact (swing feet pay
    nothing: the reference constraint is active only in contact)."""
    forces = u[:12].reshape(4, 3)
    fx, fy, fz = forces[:, 0], forces[:, 1], forces[:, 2]
    h = (fcfg.friction_coefficient * fz
         - torch.sqrt(fx * fx + fy * fy + FRICTION_CONE_REGULARIZATION))
    pen = relaxed_barrier_penalty(h, fcfg.barrier_mu, fcfg.barrier_delta)
    return torch.sum(torch.as_tensor(contact_flags, dtype=u.dtype) * pen)


_ARM_LIMITS = {}


def _arm_limits(model: RobotModel, jcfg: JointLimitsConfig):
    """(q_lo, q_hi, q_mask, v_lo, v_hi) numpy arrays, built once; joints
    with unbounded (|limit| >= 1e6) positions are masked out."""
    key = (id(model), jcfg)
    if key not in _ARM_LIMITS:
        q_lo = np.asarray(model.joint_lower[12:], dtype=np.float32)
        q_hi = np.asarray(model.joint_upper[12:], dtype=np.float32)
        mask = ((np.abs(q_lo) < 1e6) & (np.abs(q_hi) < 1e6)).astype(
            np.float32)
        _ARM_LIMITS[key] = (model, (
            q_lo, q_hi, mask,
            np.asarray(jcfg.arm_velocity_lower, dtype=np.float32),
            np.asarray(jcfg.arm_velocity_upper, dtype=np.float32)))
    return _ARM_LIMITS[key][1]


def arm_limit_cost(model: RobotModel, x, u, jcfg: JointLimitsConfig):
    """Relaxed-barrier box on arm joint positions (x[24:30]) and arm joint
    velocities (u[24:30]) (reference getJointLimitSoftConstraint)."""
    q_lo, q_hi, mask, v_lo, v_hi = (const(a, x) for a in
                                    _arm_limits(model, jcfg))
    q_arm = x[24:30]
    v_arm = u[24:30]
    p = (relaxed_barrier_penalty(q_arm - q_lo, jcfg.position_mu,
                                 jcfg.position_delta)
         + relaxed_barrier_penalty(q_hi - q_arm, jcfg.position_mu,
                                   jcfg.position_delta)) * mask
    v = (relaxed_barrier_penalty(v_arm - v_lo, jcfg.velocity_mu,
                                 jcfg.velocity_delta)
         + relaxed_barrier_penalty(v_hi - v_arm, jcfg.velocity_mu,
                                   jcfg.velocity_delta))
    return torch.sum(p) + torch.sum(v)


def ee_residual(model: RobotModel, x, p_ref, q_ref_wxyz):
    """(6,) EE pose error residual [e_pos; e_ori] (EndEffectorConstraint
    getValue, reference :34-53)."""
    p_ee, R_ee = ee_pose(model, C.state_to_q(x))
    return torch.cat([p_ee - p_ref,
                      quat_distance(R_to_quat(R_ee), q_ref_wxyz)])


def make_stage_quadratizer_parts(model: RobotModel, info: C.CentroidalInfo,
                                 cfg: QmConfig):
    """quad_xu(t, x, u, target, flags, e, Je) -> (L, Lx, Lu, Lxx, Luu, Lux)
    with the EE residual e and its x-Jacobian Je computed by the caller
    (the structured linearization gets them from its own pass). The other
    terms are analytic or small autodiff graphs without FK."""
    Q_diag_np = np.asarray(cfg.cost.q_diag) * cfg.cost.q_scaling
    R_full_np = input_cost_weight(model, cfg.cost)
    mu_np = np.asarray([cfg.cost.ee_mu_position] * 3
                       + [cfg.cost.ee_mu_orientation] * 3)
    fcfg, jcfg = cfg.friction, cfg.joint_limits

    def quad_xu(t, x, u, target: TargetTrajectory, flags, e, Je):
        Q = const(Q_diag_np, x)
        R = const(R_full_np, x)
        x_ref = interpolate_state(target, t)
        u_ref = C.weight_compensating_input(info, flags).to(x.dtype)

        dx = x - x_ref[:30]
        du = u - u_ref
        L = 0.5 * torch.sum(Q * dx * dx) + 0.5 * du @ (R @ du)
        Lx = Q * dx
        Lu = R @ du
        Lxx = torch.diag_embed(Q)
        Luu = R

        # EE soft constraint: Gauss-Newton on the precomputed residual
        mu = const(mu_np, x)
        L = L + 0.5 * torch.sum(mu * e * e)
        Lx = Lx + mtv_unrolled(Je, mu * e)
        Lxx = Lxx + mtm_unrolled(Je, mu[:, None] * Je)

        # friction cone barrier: exact derivatives in u
        def fc(uu):
            return friction_cone_cost(uu, flags, fcfg)
        L = L + fc(u)
        Lu = Lu + grad(fc)(u)
        Luu = Luu + jacfwd(grad(fc))(u)

        # arm box limits: exact (linear residuals, diagonal Hessians)
        def al_x(xx):
            return arm_limit_cost(model, xx, u, jcfg)

        def al_u(uu):
            return arm_limit_cost(model, x, uu, jcfg)
        L = L + al_x(x)
        Lx = Lx + grad(al_x)(x)
        Lxx = Lxx + jacfwd(grad(al_x))(x)
        Lu = Lu + grad(al_u)(u)
        Luu = Luu + jacfwd(grad(al_u))(u)
        Lux = torch.zeros(30, 30, dtype=x.dtype, device=x.device)
        return L, Lx, Lu, Lxx, Luu, Lux

    return quad_xu


def make_stage_quadratizer(model: RobotModel, info: C.CentroidalInfo,
                           cfg: QmConfig):
    """(quad, final_quad): the Gauss-Newton quadratic model of the stage
    cost in (x, u), quad(t, x, u, target, flags) -> (L, Lx, Lu, Lxx, Luu,
    Lux), and of the final cost, final_quad(t, x, target) -> (L, Lx, Lxx).
    EE second derivatives of the kinematics are dropped (the reference's
    EndEffectorConstraint is ConstraintOrder::Linear)."""
    quad_xu = make_stage_quadratizer_parts(model, info, cfg)
    mu_f = np.asarray([cfg.cost.final_ee_mu_position] * 3
                      + [cfg.cost.final_ee_mu_orientation] * 3)

    def ee_and_jac(t, x, target):
        p_ref, q_ref = interpolate_ee_pose(target, t)

        def res(xx):
            return ee_residual(model, xx, p_ref, q_ref)
        return res(x), jacfwd(res)(x)

    def quad(t, x, u, target: TargetTrajectory, flags):
        e, Je = ee_and_jac(t, x, target)
        return quad_xu(t, x, u, target, flags, e, Je)

    def final_quad(t, x, target: TargetTrajectory):
        e, Je = ee_and_jac(t, x, target)
        mu = const(mu_f, x)
        L = 0.5 * torch.sum(mu * e * e)
        Lx = Je.T @ (mu * e)
        Lxx = Je.T @ (mu[:, None] * Je)
        return L, Lx, Lxx

    return quad, final_quad


def make_stage_cost(model: RobotModel, info: C.CentroidalInfo,
                    cfg: QmConfig):
    """(stage_cost(t, x, u, target, contact_flags) -> scalar,
    final_cost(t, x, target) -> scalar)."""
    Q_diag_np = np.asarray(cfg.cost.q_diag) * cfg.cost.q_scaling
    R_full_np = input_cost_weight(model, cfg.cost)

    def stage_cost(t, x, u, target: TargetTrajectory, contact_flags):
        x_ref = interpolate_state(target, t)
        u_ref = C.weight_compensating_input(info, contact_flags).to(x.dtype)
        p_ref, q_ref = interpolate_ee_pose(target, t)
        c = tracking_cost(x, u, x_ref[:30], u_ref, const(Q_diag_np, x),
                          const(R_full_np, x))
        c = c + ee_cost(model, x, p_ref, q_ref, cfg.cost.ee_mu_position,
                        cfg.cost.ee_mu_orientation)
        c = c + friction_cone_cost(u, contact_flags, cfg.friction)
        c = c + arm_limit_cost(model, x, u, cfg.joint_limits)
        return c

    def final_cost(t, x, target: TargetTrajectory):
        p_ref, q_ref = interpolate_ee_pose(target, t)
        return ee_cost(model, x, p_ref, q_ref,
                       cfg.cost.final_ee_mu_position,
                       cfg.cost.final_ee_mu_orientation)

    return stage_cost, final_cost
