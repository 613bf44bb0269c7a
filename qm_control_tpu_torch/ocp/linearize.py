"""Structured (analytic) stage linearization (port of
qm_control_tpu/ocp/linearize.py; the default path,
MpcConfig.structured_linearize = True).

It computes what one 60-tangent forward-mode pass through the whole stage
would give, with tangents only where they are irreducible:

  * the flow map is LINEAR in u given the state, f(x, u) = c(x) + D(x) u,
    so its Jacobians need foot positions and Jacobians (one
    chainfk.foot_kinematics primal per RK2 stage), the SRBD COM rotation
    derivative (closed form) and the 6-dim base-velocity map's Jacobian
    (9 tangents);
  * RK2 derivatives follow by the exact chain rule from the two stage
    Jacobians, F = x + dt f(x + dt/2 f(x, u), u);
  * of the input map u = u0(x) + N(x) w only the 12 leg velocities depend
    on x: 12 outputs x 21 tangents through the leg chains;
  * the EE residual Jacobian takes 12 tangents (base pose 6 + arm 6).

The (30,30) matrices are assembled from row and column blocks by
concatenation (no in-place writes: the function runs under
torch.func.vmap over the MPC nodes). Reference parity: replaces the
CppAD-codegen Jacobians of QMDynamicsAD::linearApproximation
(qm_interface/src/dynamics/QMDynamicsAD.cpp:12-33).
"""
import numpy as np
import torch

from ..config import QmConfig
from ..models import centroidal as C
from ..models import chainfk
from ..models._const import const
from ..models._fwd import jacfwd
from ..models.rotations import euler_zyx_to_R, skew
from ..models.smallmat import mm_unrolled, mtm_unrolled, mtv_unrolled
from ..models.spec import CONTACT_LEG_JOINTS, RobotModel
from .constraints import (_DAMP, FOOT_FOR_BLOCK, _damped_solve, leg_blocks,
                          leg_null_block, swing_projectors)
from .costs import ee_residual, make_stage_quadratizer_parts
from .reference import TargetTrajectory, interpolate_ee_pose


def value_and_jacfwd(f, p):
    """(f(p), df/dp (out, in)) by forward mode, one tangent per input."""
    def both(z):
        out = f(z)
        return out, out
    jac, val = jacfwd(both, has_aux=True)(p)
    return val, jac


def _euler_rate_axes(zyx):
    """World-frame axes (3,3) [az | ay | ax]: the position derivative of a
    base-fixed point w.r.t. the ZYX Euler angles is [a_k x r] per column."""
    cz, sz = torch.cos(zyx[0]), torch.sin(zyx[0])
    cy, sy = torch.cos(zyx[1]), torch.sin(zyx[1])
    zero = torch.zeros_like(cz)
    az = torch.stack([zero, zero, torch.ones_like(cz)])
    ay = torch.stack([-sz, cz, zero])
    ax = torch.stack([cz * cy, sz * cy, -sy])
    return torch.stack([az, ay, ax], dim=1)        # (3,3) columns


def make_structured_linearize(model: RobotModel, info: C.CentroidalInfo,
                              cfg: QmConfig):
    """stage_linearize(t, flags, zdot, x, w, target, ee_wrench=None) ->
    (A, B, dt*L, dt*lx, dt*lw, dt*lxx, dt*lww, dt*lwx); with ee_wrench the
    dynamics carry the world wrench [f(3); tau(3)] at the arm EE
    (centroidal.flow_map)."""
    stage_q_xu = make_stage_quadratizer_parts(model, info, cfg)
    dt = cfg.mpc.dt
    mass = info.mass
    r_com = np.asarray(info.r_com_base, dtype=np.float64)
    gravity = np.array([0.0, 0.0, -C.GRAVITY])

    def z(r, c, like):
        return torch.zeros(r, c, dtype=like.dtype, device=like.device)

    def eye(n, like):
        return torch.eye(n, dtype=like.dtype, device=like.device)

    def com_and_jac(x):
        """SRBD COM position and its Jacobian w.r.t. x[6:12]."""
        R = euler_zyx_to_R(x[9:12])
        r_w = R @ const(r_com, x)
        p_com = x[6:9] + r_w
        ax = _euler_rate_axes(x[9:12])
        J_rot = torch.stack([torch.linalg.cross(ax[:, k], r_w)
                             for k in range(3)], dim=1)      # (3,3)
        return p_com, torch.cat([eye(3, x), J_rot], dim=1)   # (3,), (3,6)

    def base_dot_and_jac(x):
        """base_velocity_from_momentum and its (6,9) Jacobian w.r.t. its 9
        inputs (momentum 0:6, Euler angles 9:12)."""
        def f(p9):
            xx = torch.cat([p9[:6], x[6:9], p9[6:9], x[12:30]])
            return C.base_velocity_from_momentum(info, xx)
        return value_and_jacfwd(f, torch.cat([x[:6], x[9:12]]))

    def flow_and_jacs(x, u, ee_wrench=None, ee_pJ=None):
        """f(x,u) with the Jacobians in compact row-block form: R (9,30) =
        rows 3:12 of Jx (its only nonzero rows), S (6,30) = rows 0:6 of Ju
        (rows 6:12 are zero, rows 12:30 the constant [0 I18]).
        ee_pJ: (p_ee, J_ee (3,30)) at this state when ee_wrench is set."""
        p_feet, Jb, Jl = chainfk.foot_kinematics(model, C.state_to_q(x))
        forces = u[:12].reshape(4, 3)
        p_com, J_com6 = com_and_jac(x)
        bd, J_bd9 = base_dot_and_jac(x)

        f_total = forces.sum(0)
        r = p_feet - p_com[None, :]                          # (4,3)
        tau_com = torch.linalg.cross(r, forces).sum(0)

        # rows 3:6 of Jx: d(sum_i r_i x f_i)/dx / m
        Sf = skew(forces)                                    # (4,3,3)
        Jang_base = (-torch.einsum("fij,fjk->ik", Sf, Jb)
                     + skew(f_total) @ J_com6)               # (3,6)
        Jang_leg = -torch.einsum("fij,fjk->fik", Sf, Jl)     # (4,3,3)
        Jang_legs12 = torch.cat([Jang_leg[f] for f in FOOT_FOR_BLOCK],
                                dim=1)                       # (3,12)
        row36 = torch.cat([z(3, 6, x), Jang_base, Jang_legs12, z(3, 6, x)],
                          dim=1) / mass
        if ee_wrench is not None:
            # the wrench at the EE: f_total += w_f, tau_com += (p_ee -
            # p_com) x w_f + w_tau, so rows 3:6 gain -skew(w_f) (J_ee -
            # J_com) / m
            wr = torch.as_tensor(ee_wrench, dtype=x.dtype, device=x.device)
            p_ee, J_ee = ee_pJ
            f_total = f_total + wr[:3]
            tau_com = (tau_com + torch.linalg.cross(p_ee - p_com, wr[:3])
                       + wr[3:])
            J_com30 = torch.cat([z(3, 6, x), J_com6, z(3, 18, x)], dim=1)
            row36 = row36 - skew(wr[:3]) @ (J_ee - J_com30) / mass
        # rows 6:12: the base velocity map
        row612 = torch.cat([J_bd9[:, :6], z(6, 3, x), J_bd9[:, 6:9],
                            z(6, 18, x)], dim=1)
        R = torch.cat([row36, row612], dim=0)                # (9,30)

        # Ju rows: 0:3 forces/m; 3:6 skew(r_i)/m (12:30 identity, constant)
        urow03 = torch.cat([eye(3, x).repeat(1, 4) / mass, z(3, 18, x)],
                           dim=1)
        Sr = skew(r)
        Sr12 = torch.cat([Sr[f] for f in range(4)], dim=1) / mass
        urow36 = torch.cat([Sr12, z(3, 18, x)], dim=1)
        S = torch.cat([urow03, urow36], dim=0)               # (6,30)

        f_val = torch.cat([f_total / mass + const(gravity, x),
                           tau_com / mass, bd, u[12:30]])
        return f_val, R, S

    def legvel_rows(x, w, flags, zdot):
        """The 12 leg-velocity components of u = u0(x) + N(x) w, in joint
        order: the only x-dependent rows of the input map."""
        base_dot = C.base_velocity_from_momentum(info, x)
        _, Jb, Jl = chainfk.foot_kinematics(model, C.state_to_q(x))
        c = flags.to(x.dtype)
        rhs = -torch.einsum("fij,j->fi", Jb, base_dot)
        u_stance = _damped_solve(Jl, rhs)                    # (4,3)
        a = Jl[:, 2, :]
        b = zdot - Jb[:, 2, :] @ base_dot
        aa = torch.sum(a * a, dim=1) + _DAMP
        u_swing = a * (b / aa)[:, None]
        w_legs = torch.stack([w[12 + CONTACT_LEG_JOINTS[f][0]:
                                12 + CONTACT_LEG_JOINTS[f][0] + 3]
                              for f in range(4)])            # (4,3) foot order
        Pw = w_legs - a * (torch.sum(a * w_legs, dim=1) / aa)[:, None]
        rows = (c[:, None] * u_stance
                + (1.0 - c[:, None]) * (u_swing + Pw))       # (4,3)
        return leg_blocks(rows)                              # (12,)

    def param_and_jac(x, w, flags, zdot):
        """u (30,) and the input map in compact block form: Jlegs (12,30),
        the x-Jacobian of the 12 leg velocities (21 tangents); N =
        blockdiag(diag(cf12), Nl, I6) as cf12 (12,) and Nl (12,12)."""
        def f(p21):
            xx = torch.cat([p21[:6], x[6:9], p21[6:9], p21[9:21], x[24:30]])
            return legvel_rows(xx, w, flags, zdot)

        legs, J21 = value_and_jacfwd(
            f, torch.cat([x[:6], x[9:12], x[12:24]]))        # (12,), (12,21)
        Jlegs = torch.cat([J21[:, :6], z(12, 3, x), J21[:, 6:9],
                           J21[:, 9:21], z(12, 6, x)], dim=1)  # (12,30)
        c = flags.to(x.dtype)
        cf12 = torch.repeat_interleave(c, 3)
        u = torch.cat([cf12 * w[:12], legs, w[24:30]])
        _, _, Jl = chainfk.foot_kinematics(model, C.state_to_q(x))
        P_swing, _ = swing_projectors(Jl[:, 2, :])
        return u, Jlegs, cf12, leg_null_block(c, P_swing)

    def ee_and_jac(x, p_ref, q_ref):
        """EE residual e (6,) and Je (6,30) (12 tangents, arm chain); the EE
        position and its (3,30) Jacobian are e[:3] + p_ref and Je[:3]."""
        def f(p12):
            xx = torch.cat([x[:6], p12[:6], x[12:24], p12[6:12]])
            return ee_residual(model, xx, p_ref, q_ref)

        e, J12 = value_and_jacfwd(f, torch.cat([x[6:12], x[24:30]]))
        Je = torch.cat([z(6, 6, x), J12[:, :6], z(6, 12, x), J12[:, 6:12]],
                       dim=1)
        return e, Je

    def stage_linearize(t, flags, zdot, x, w, target: TargetTrajectory,
                        ee_wrench=None):
        p_ref, q_ref = interpolate_ee_pose(target, t)
        e, Je = ee_and_jac(x, p_ref, q_ref)
        u, Jlegs, cf12, Nl = param_and_jac(x, w, flags, zdot)
        ee_pJ = None if ee_wrench is None else (e[:3] + p_ref, Je[:3])
        f0, R0, S0 = flow_and_jacs(x, u, ee_wrench, ee_pJ)
        x_mid = x + 0.5 * dt * f0
        if ee_wrench is not None:
            # the wrench's state Jacobian needs the EE Jacobian at x_mid
            e_m, Je_m = ee_and_jac(x_mid, p_ref, q_ref)
            ee_pJ = (e_m[:3] + p_ref, Je_m[:3])
        _, R1, S1 = flow_and_jacs(x_mid, u, ee_wrench, ee_pJ)

        # F = x + dt f(x + dt/2 f(x,u), u): exact RK2 chain rule in
        # row-block form (Jx has 9 nonzero rows 3:12, Ju 6 variable rows)
        I = eye(30, x)
        R_A = R1 + 0.5 * dt * mm_unrolled(R1[:, 3:12], R0)   # rows 3:12 of (A-I)/dt
        T = mm_unrolled(R1[:, 0:6], S0)                      # (9,30)
        T = torch.cat([T[:, :12], T[:, 12:30] + R1[:, 12:30]], dim=1)
        # U = rows 0:12 of dF/du; rows 12:30 are dt [0 I18] (constant)
        h = 0.5 * dt * dt
        U = torch.cat([dt * S1[0:3], dt * S1[3:6] + h * T[0:3], h * T[3:9]],
                      dim=0)                                 # (12,30)
        # A += dF/du @ du/dx (du/dx nonzero only in rows 12:24 = Jlegs)
        UJ = mm_unrolled(U[:, 12:24], Jlegs)                 # (12,30)
        A = torch.cat([I[0:3] + UJ[0:3], (I[3:12] + dt * R_A) + UJ[3:12],
                       I[12:24] + dt * Jlegs, I[24:30]], dim=0)
        # B = dF/du @ N, N = blockdiag(diag(cf12), Nl, I6)
        B = torch.cat([
            torch.cat([U[:, 0:12] * cf12[None, :], mm_unrolled(U[:, 12:24], Nl),
                       U[:, 24:30]], dim=1),
            torch.cat([z(12, 12, x), dt * Nl, z(12, 6, x)], dim=1),
            torch.cat([z(6, 24, x), dt * eye(6, x)], dim=1)], dim=0)

        L, Lx, Lu, Lxx, Luu, Lux = stage_q_xu(t, x, u, target, flags, e, Je)

        def NT_rows(G):
            """N' @ G for (30, m) G, by the block structure."""
            return torch.cat([cf12[:, None] * G[0:12],
                              mtm_unrolled(Nl, G[12:24]), G[24:30]], dim=0)

        lx = Lx + mtv_unrolled(Jlegs, Lu[12:24])
        lw = NT_rows(Lu[:, None])[:, 0]
        LuuJu = mm_unrolled(Luu[:, 12:24], Jlegs)            # (30,30), k=12
        JuLux = mtm_unrolled(Jlegs, Lux[12:24, :])           # (30,30), k=12
        lxx = (Lxx + JuLux + JuLux.transpose(-1, -2)
               + mtm_unrolled(Jlegs, LuuJu[12:24, :]))
        lwx = NT_rows(Lux + LuuJu)
        Kb = torch.cat([Luu[:, 0:12] * cf12[None, :],
                        mm_unrolled(Luu[:, 12:24], Nl), Luu[:, 24:30]], dim=1)
        lww = NT_rows(Kb)
        return (A, B, dt * L, dt * lx, dt * lw, dt * lxx, dt * lww,
                dt * lwx)

    return stage_linearize
