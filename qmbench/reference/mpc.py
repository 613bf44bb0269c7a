"""The MPC of the plain reference: the reference controller's optimal
control problem (upstream qm_control, QMInterface.cpp:79-142, task.info)
and one Gauss-Newton SQP iteration on it, written from those semantics:

- state x (30) = [centre-of-mass velocity, angular momentum / mass, base
  position, zyx Euler angles, 18 joint angles]; input u (30) = [4 contact
  forces (LF, RF, LH, RH, world), 18 joint velocities];
- the flow map of the single rigid body (nominal inertia), integrated by
  the RK2 midpoint rule with the input held over the node;
- the contact constraints (stance foot still; swing foot force-free, its
  normal velocity on the swing reference) eliminated as u = u0(x) + N(x) w
  by a damped per-leg solve and a rank-2 projector;
- the costs: quadratic state and input tracking (the foot-velocity input
  weight), the end-effector pose penalty, relaxed-barrier friction cones
  and arm joint limits;
- the Gauss-Newton model: first derivatives of the dynamics and of u(x, w)
  by forward-mode autodiff (torch.func.jacfwd), the end-effector term by
  its residual's Jacobian, the barriers by their exact derivatives;
- a textbook Riccati sweep with defects and a filter line search over a
  few step lengths.

Everything is unbatched over scenarios: one scenario at a time, the nodes
of its horizon along a leading axis. Nothing here comes from the port.
"""
import math

import numpy as np
import torch
from torch.func import jacfwd

from .robot import (EE, FEET, FOOT_JOINTS, GRAVITY, Centroidal, Robot,
                    cross, euler_rate_matrix, euler_zyx_to_R, mv,
                    nominal_q, quat_error, R_to_quat, slerp)

# task.info of the reference (the Q and R diagonals, mu, barriers)
Q_DIAG = (50.0, 50.0, 300.0, 10.0, 30.0, 30.0,
          1000.0, 1000.0, 3000.0, 1000.0, 2000.0, 2000.0,
          5.0, 5.0, 2.5, 5.0, 5.0, 2.5, 5.0, 5.0, 2.5, 5.0, 5.0, 2.5,
          0.0, 0.0, 5.0, 0.0, 0.0, 0.0)
R_DIAG = (5.0,) * 12 + (5000.0,) * 12 + (1000.0,) * 6
R_SCALE = 1e-3
EE_MU = (2000.0,) * 3 + (1000.0,) * 3
FRICTION_MU, FRICTION_BARRIER = 0.3, (0.1, 5.0)
FRICTION_REG = 25.0
LIMIT_BARRIER = (0.1, 1e-3)
ARM_VEL = (0.628, 0.628, 0.628, 0.837, 0.837, 0.837)
SWING = dict(lift_off=0.05, touch_down=-0.1, height=0.15,
             after_horizon=0.2, time_scale=0.15)
DAMP = 1e-6
SQP = dict(reg=1e-5, g_max=1e-2, g_min=1e-6, alphas=(1.0, 0.5, 0.15, 0.03))


# -- the schedule and the target ----------------------------------------------

def contact_flags(mode):
    """(..., 4) 0/1 of a mode number (8 LF + 4 RF + 2 LH + RH)."""
    return torch.stack([(mode >> s) & 1 for s in (3, 2, 1, 0)], -1)


class Schedule:
    """A mode schedule: modes[i] holds on [events[i-1], events[i])."""

    def __init__(self, events, modes):
        self.events = [float(e) for e in events]
        self.modes = [int(m) for m in modes]

    def mode_at(self, t):
        ev = torch.as_tensor(self.events, dtype=t.dtype, device=t.device)
        idx = (ev <= t[..., None]).sum(-1)
        return torch.as_tensor(self.modes, device=t.device)[idx]

    def swing_zdot(self, foot, t, horizon_end):
        """The swing foot's normal-velocity reference (two cubic Hermite
        segments lift-off -> apex -> touch-down, amplitude scaled by the
        swing's duration) at the times t."""
        c = [(m >> (3, 2, 1, 0)[foot]) & 1 for m in self.modes]
        lifts = [e for b, e in enumerate(self.events) if c[b] and not c[b + 1]]
        touches = [e for b, e in enumerate(self.events)
                   if not c[b] and c[b + 1]]
        out = []
        for tt in t.tolist():
            lo = max([e for e in lifts if e <= tt], default=None)
            td = min([e for e in touches if e > tt], default=None)
            lo = tt - 0.3 if lo is None else lo
            td = horizon_end + SWING["after_horizon"] if td is None else td
            out.append(_swing_rate(tt, lo, td))
        return torch.tensor(out, dtype=t.dtype, device=t.device)


def _hermite_rate(t, t0, t1, z0, z1, v0, v1):
    d = max(t1 - t0, 1e-6)
    s = (t - t0) / d
    return ((6 * s * s - 6 * s) * z0 / d + (3 * s * s - 4 * s + 1) * v0
            + (-6 * s * s + 6 * s) * z1 / d + (3 * s * s - 2 * s) * v1)


def _swing_rate(t, t0, t1):
    dur = t1 - t0
    k = min(dur / SWING["time_scale"], 1.0)
    zmax, tm = SWING["height"] * k, 0.5 * (t0 + t1)
    if t <= tm:
        return _hermite_rate(t, t0, tm, 0.0, zmax, SWING["lift_off"] * k,
                             0.0)
    return _hermite_rate(t, tm, t1, zmax, 0.0, 0.0, SWING["touch_down"] * k)


class Target:
    """Knots (times (K,), states (K, 37)): linear between knots, slerp on
    the end-effector quaternion (x, y, z, w at 33:37), held outside."""

    def __init__(self, times, states, dtype, device):
        self.times = torch.as_tensor(times, dtype=dtype, device=device)
        self.states = torch.as_tensor(np.asarray(states), dtype=dtype,
                                      device=device)

    def at(self, t):
        K = self.times.shape[0]
        idx = torch.clamp((self.times <= t[..., None]).sum(-1) - 1, 0, K - 2)
        t0, t1 = self.times[idx], self.times[idx + 1]
        span = torch.where(t1 - t0 < 1e-9, torch.ones_like(t0), t1 - t0)
        s = torch.clamp((t - t0) / span, 0.0, 1.0)
        a, b = self.states[idx], self.states[idx + 1]
        lin = a + s[..., None] * (b - a)
        wxyz = lambda x: torch.cat([x[..., 36:37], x[..., 33:36]], -1)  # noqa
        return lin[..., :30], lin[..., 30:33], slerp(wxyz(a), wxyz(b), s)


# -- the problem --------------------------------------------------------------

class Ocp:
    """The OCP's pieces in one dtype on one device."""

    def __init__(self, robot: Robot, info: Centroidal, N, dt):
        self.robot, self.info, self.N, self.dt = robot, info, N, dt
        t = lambda a: torch.as_tensor(a, dtype=robot.dtype,  # noqa
                                      device=robot.device)
        self.Q = t(Q_DIAG)
        self.mu_ee = t(EE_MU)
        # the input weight: the leg joint-velocity block weighs the feet's
        # velocity relative to the base at the nominal stance
        q = nominal_q((0.0, 0.0, 0.4), robot.dtype, robot.device)
        kin = robot.fk(q)
        Jf = torch.cat([robot.frame_jacobian(kin, f)[:3] for f in FEET])
        B = Jf[:, 6:18]
        R = torch.diag(t(R_DIAG)) * R_SCALE
        R[12:24, 12:24] = B.T @ R[12:24, 12:24] @ B
        self.R = R
        lo, hi = robot.joint_lower[12:], robot.joint_upper[12:]
        self.arm_q = (lo, hi, ((lo.abs() < 1e6) & (hi.abs() < 1e6)))
        self.arm_v = t(ARM_VEL)
        self.gvec = t([0.0, 0.0, -GRAVITY])

    # the dynamics
    def base_rates(self, x):
        """[base linear velocity, zyx rates] from the momentum of x."""
        info = self.info
        R = euler_zyx_to_R(x[..., 9:12])
        Iw = R @ info.I_com @ R.transpose(-1, -2)
        w = torch.linalg.solve(Iw, (info.mass * x[..., 3:6]).unsqueeze(-1)
                               ).squeeze(-1)
        pdot = x[..., 0:3] - cross(w, mv(R, info.r_com.expand(w.shape)))
        zyx_dot = torch.linalg.solve(euler_rate_matrix(x[..., 9:12]),
                                     w.unsqueeze(-1)).squeeze(-1)
        return torch.cat([pdot, zyx_dot], -1)

    def flow(self, x, u):
        info = self.info
        F = u[..., :12].reshape(u.shape[:-1] + (4, 3))
        feet = self.robot.feet(x[..., 6:30])
        R = euler_zyx_to_R(x[..., 9:12])
        com = x[..., 6:9] + mv(R, info.r_com.expand(x[..., 6:9].shape))
        torque = cross(feet - com.unsqueeze(-2), F).sum(-2)
        return torch.cat([F.sum(-2) / info.mass + self.gvec,
                          torque / info.mass, self.base_rates(x),
                          u[..., 12:30]], -1)

    def rk2(self, x, u):
        k1 = self.flow(x, u)
        return x + self.dt * self.flow(x + 0.5 * self.dt * k1, u)

    # the contact constraints, eliminated
    def input_map(self, x, flags, zdot):
        """(u0 (..., 30), N (..., 30, 30)) with u = u0 + N w."""
        robot = self.robot
        kin = robot.fk(x[..., 6:30])
        base = self.base_rates(x)
        c = flags.to(x.dtype)
        eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
        legs, blocks = [None] * 4, [None] * 4
        for f, name in enumerate(FEET):
            J = robot.frame_jacobian(kin, name)[..., :3, :]
            cols = [6 + j for j in FOOT_JOINTS[f]]
            Jb, Jl = J[..., :6], J[..., cols]
            jb = mv(Jb, base)
            # stance: the foot still, Jl u = -Jb base, damped least squares
            G = Jl @ Jl.transpose(-1, -2) + DAMP * eye3
            u_st = mv(Jl.transpose(-1, -2), torch.linalg.solve(
                G, -jb.unsqueeze(-1)).squeeze(-1))
            # swing: a . u = zdot - (Jb base)_z, least norm; free in the
            # null space of a
            a = Jl[..., 2, :]
            aa = (a * a).sum(-1, keepdim=True) + DAMP
            u_sw = a * (zdot[..., f, None] - jb[..., 2:3]) / aa
            P = eye3 - a.unsqueeze(-1) * a.unsqueeze(-2) / aa.unsqueeze(-1)
            cf = c[..., f, None]
            blk = FOOT_JOINTS[f][0] // 3      # its joints' place in u
            legs[blk] = cf * u_st + (1 - cf) * u_sw
            blocks[blk] = (1 - cf).unsqueeze(-1) * P
        shape = x.shape[:-1]
        zeros = lambda n: torch.zeros(shape + (n,), dtype=x.dtype,  # noqa
                                      device=x.device)
        u0 = torch.cat([zeros(12)] + legs + [zeros(6)], -1)
        Nm = torch.diag_embed(torch.cat([c.repeat_interleave(3, -1),
                                         zeros(12), zeros(6) + 1], -1))
        Nm = Nm + torch.nn.functional.pad(_blocks(torch.stack(blocks, -3)),
                                          (12, 6, 12, 6))
        return u0, Nm

    # the costs
    def ee_residual(self, x, p_ref, q_ref):
        kin = self.robot.fk(x[..., 6:30])
        p, R = self.robot.frame(kin, EE)
        return torch.cat([p - p_ref, quat_error(R_to_quat(R), q_ref)], -1)

    def u_ref(self, flags):
        c = flags.to(self.robot.dtype)
        n = torch.clamp(c.sum(-1, keepdim=True), min=1.0)
        fz = c * self.info.mass * GRAVITY / n
        z = torch.zeros_like(fz)
        F = torch.stack([z, z, fz], -1).reshape(fz.shape[:-1] + (12,))
        return torch.cat([F, torch.zeros(F.shape[:-1] + (18,), dtype=F.dtype,
                                         device=F.device)], -1)

    @staticmethod
    def barrier(h, mu, delta):
        """(value, first, second derivative) of the relaxed log barrier."""
        inside = h > delta
        hs = torch.where(inside, h, torch.full_like(h, delta))
        val = torch.where(inside, -mu * torch.log(hs), mu * (
            -math.log(delta) + 0.5 * ((h - 2 * delta) / delta) ** 2 - 0.5))
        d1 = torch.where(inside, -mu / hs, mu * (h - 2 * delta) / delta ** 2)
        d2 = torch.where(inside, mu / (hs * hs),
                         torch.full_like(h, mu / delta ** 2))
        return val, d1, d2

    def friction(self, u, flags):
        """(value, gradient (30), Hessian (30, 30)) in u."""
        c = flags.to(u.dtype)
        F = u[..., :12].reshape(u.shape[:-1] + (4, 3))
        s = torch.sqrt(F[..., 0] ** 2 + F[..., 1] ** 2 + FRICTION_REG)
        h = FRICTION_MU * F[..., 2] - s
        p, d1, d2 = self.barrier(h, *FRICTION_BARRIER)
        gh = torch.stack([-F[..., 0] / s, -F[..., 1] / s,
                          torch.full_like(s, FRICTION_MU)], -1)
        xy = F[..., :2]
        Hh = torch.zeros(F.shape + (3,), dtype=u.dtype, device=u.device)
        Hxy = -(torch.eye(2, dtype=u.dtype, device=u.device)
                - xy.unsqueeze(-1) * xy.unsqueeze(-2)
                / (s * s)[..., None, None]) / s[..., None, None]
        Hh = Hh + torch.nn.functional.pad(Hxy, (0, 1, 0, 1))
        g = (c * d1)[..., None] * gh
        H = (c * d2)[..., None, None] * gh.unsqueeze(-1) * gh.unsqueeze(-2) \
            + (c * d1)[..., None, None] * Hh
        grad = torch.cat([g.reshape(u.shape[:-1] + (12,)),
                          torch.zeros(u.shape[:-1] + (18,), dtype=u.dtype,
                                      device=u.device)], -1)
        Hu = torch.nn.functional.pad(_blocks(H), (0, 18, 0, 18))
        return (c * p).sum(-1), grad, Hu

    def limits(self, q, lo, hi, mask):
        """Barriers on both sides of a box: (value, gradient, Hessian
        diagonal), joints outside `mask` free."""
        a, da, dda = self.barrier(q - torch.where(mask, lo, q - 1),
                                  *LIMIT_BARRIER)
        b, db, ddb = self.barrier(torch.where(mask, hi, q + 1) - q,
                                  *LIMIT_BARRIER)
        z = torch.zeros_like(q)
        return (torch.where(mask, a + b, z).sum(-1),
                torch.where(mask, da - db, z), torch.where(mask, dda + ddb, z))

    def arm(self, x, u):
        """Barriers on the arm's joint angles (x) and velocities (u):
        (value, d/dx (30), d2/dx2 diagonal (30), d/du, d2/du2 diagonal)."""
        lo, hi, mask = self.arm_q
        vq, gq, hq = self.limits(x[..., 24:30], lo, hi, mask)
        vmask = torch.ones_like(mask)
        vv, gv, hv = self.limits(u[..., 24:30], -self.arm_v, self.arm_v,
                                 vmask)
        pad = lambda a: torch.nn.functional.pad(a, (24, 0))  # noqa
        return vq + vv, pad(gq), pad(hq), pad(gv), pad(hv)

    def stage_cost(self, t, x, u, flags, target):
        """dt x the stage cost (value only), for the merit."""
        x_ref, p_ref, q_ref = target.at(t)
        dx, du = x - x_ref, u - self.u_ref(flags)
        L = 0.5 * (self.Q * dx * dx).sum(-1) + 0.5 * (du * mv(self.R, du)
                                                      ).sum(-1)
        e = self.ee_residual(x, p_ref, q_ref)
        L = L + 0.5 * (self.mu_ee * e * e).sum(-1)
        L = L + self.friction(u, flags)[0] + self.arm(x, u)[0]
        return self.dt * L

    def final_cost(self, t, x, target):
        _, p_ref, q_ref = target.at(t)
        e = self.ee_residual(x, p_ref, q_ref)
        return 0.5 * (self.mu_ee * e * e).sum(-1)


def _blocks(H):
    """(..., 4, 3, 3) -> (..., 12, 12) block diagonal."""
    out = 0.0
    for f in range(4):
        out = out + torch.nn.functional.pad(
            H[..., f, :, :], (3 * f, 9 - 3 * f, 3 * f, 9 - 3 * f))
    return out


# -- one SQP iteration --------------------------------------------------------

class Policy:
    """A solve's result: node times, states X (N+1, 30), inputs U (N+1,
    30, the last repeated), modes (N+1), the cost, the reduced inputs W."""

    def __init__(self, t_nodes, X, U, modes, cost, W):
        self.t_nodes, self.X, self.U, self.modes = t_nodes, X, U, modes
        self.cost, self.W = cost, W

    def at(self, t):
        """(x, u, mode) at time t: linear between nodes, the mode of the
        node at or before t."""
        tn = self.t_nodes
        i = int(torch.clamp((tn <= t).sum() - 1, 0, tn.shape[0] - 2))
        a = float(torch.clamp((t - tn[i]) / torch.clamp(tn[i + 1] - tn[i],
                                                        min=1e-9), 0, 1))
        return ((1 - a) * self.X[i] + a * self.X[i + 1],
                (1 - a) * self.U[i] + a * self.U[i + 1], int(self.modes[i]))


class Mpc:
    """One solve of the reference's MPC: a scenario's OCP at time t from
    state x, started from a warm (X, W) shifted onto the new horizon, or
    cold (the state held, the weight spread over the stance feet)."""

    def __init__(self, robot, info, horizon, dt):
        self.N = int(round(horizon / dt))
        self.horizon, self.dt = horizon, dt
        self.ocp = Ocp(robot, info, self.N, dt)
        self.dtype, self.device = robot.dtype, robot.device

    def nodes(self, t, schedule: Schedule):
        tn = t + self.dt * torch.arange(self.N + 1, dtype=self.dtype,
                                        device=self.device)
        modes = schedule.mode_at(tn)
        flags = contact_flags(modes).to(self.dtype)
        zdot = torch.stack([schedule.swing_zdot(f, tn, float(t)
                                                + self.horizon)
                            for f in range(4)], -1)
        return tn, modes, flags, zdot

    @staticmethod
    def shift(Y, s, dt):
        """Y moved s seconds later on its node grid, linearly between
        nodes, the last value held."""
        n = Y.shape[0]
        pos = torch.arange(n, dtype=Y.dtype, device=Y.device) + s / dt
        i0 = torch.clamp(torch.floor(pos).long(), 0, n - 1)
        i1 = torch.clamp(i0 + 1, 0, n - 1)
        a = torch.clamp(pos - i0.to(Y.dtype), 0.0, 1.0)[:, None]
        return (1 - a) * Y[i0] + a * Y[i1]

    def solve(self, t, x0, target: Target, schedule: Schedule, W_warm=None,
              X_warm=None, shift=0.0):
        o, N = self.ocp, self.N
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)
        x0 = torch.as_tensor(x0).to(self.dtype).to(self.device)
        tn, modes, flags, zdot = self.nodes(t, schedule)
        ts, fl, zd = tn[:-1], flags[:-1], zdot[:-1]
        if W_warm is None:
            W = o.u_ref(fl)
            X = x0.expand(N + 1, 30).clone()
        else:
            W = self.shift(W_warm.to(x0), shift, self.dt)
            X = self.shift(X_warm.to(x0), shift, self.dt)
        X = torch.cat([x0[None], X[1:]])

        def input_of(Xs, Ws, idx=slice(None)):
            u0, Nm = o.input_map(Xs, fl[idx], zd[idx])
            return u0 + mv(Nm, Ws)

        def merit(Xs, Ws):
            """(cost, defects) of trajectories with any leading shape."""
            U = input_of(Xs[..., :-1, :], Ws)
            cost = o.stage_cost(ts, Xs[..., :-1, :], U, fl, target).sum(-1) \
                + o.final_cost(tn[-1], Xs[..., -1, :], target)
            return cost, o.rk2(Xs[..., :-1, :], U) - Xs[..., 1:, :]

        cost, d = merit(X, W)
        vio = d.abs().sum()

        # the Gauss-Newton model at (X, W)
        Xn = X[:-1]
        _, p_ref, q_ref = target.at(ts)

        def node_maps(z):
            xx, ww = Xn + z[:30], W + z[30:]
            u = input_of(xx, ww)
            return torch.cat([o.rk2(xx, u), u,
                              o.ee_residual(xx, p_ref, q_ref)], -1)

        z0 = torch.zeros(60, dtype=self.dtype, device=self.device)
        J = jacfwd(node_maps)(z0)                          # (N, 66, 60)
        out = node_maps(z0)
        u, e = out[:, 30:60], out[:, 60:]
        A, B = J[:, :30, :30], J[:, :30, 30:]
        Ju, Nm, Je = J[:, 30:60, :30], J[:, 30:60, 30:], J[:, 60:, :30]
        x_ref, _, _ = target.at(ts)
        dx, du = Xn - x_ref, u - o.u_ref(fl)
        mu = o.mu_ee
        _, gf, Hf = o.friction(u, fl)
        _, gqx, hqx, gqu, hqu = o.arm(Xn, u)
        Lx = o.Q * dx + mv(Je.transpose(-1, -2), mu * e) + gqx
        Lu = mv(o.R, du) + gf + gqu
        Lxx = torch.diag_embed(o.Q + hqx) + Je.transpose(-1, -2) @ (
            mu[:, None] * Je)
        Luu = o.R + Hf + torch.diag_embed(hqu)
        JuT, NT = Ju.transpose(-1, -2), Nm.transpose(-1, -2)
        dt = self.dt
        lx = dt * (Lx + mv(JuT, Lu))
        lu = dt * mv(NT, Lu)
        lxx = dt * (Lxx + JuT @ Luu @ Ju)
        luu = dt * (NT @ Luu @ Nm)
        lux = dt * (NT @ Luu @ Ju)
        ref_N = target.at(tn[-1:])[1:]
        eN = o.ee_residual(X[-1:], *ref_N)[0]
        JeN = jacfwd(lambda z: o.ee_residual(X[-1:] + z, *ref_N))(
            torch.zeros(30, dtype=self.dtype, device=self.device))[0]
        Vx = JeN.T @ (mu * eN)
        Vxx = JeN.T @ (mu[:, None] * JeN)
        Vxx = 0.5 * (Vxx + Vxx.T)

        # the Riccati sweep with defects
        nw = W.shape[1]
        reg = SQP["reg"] * torch.eye(nw, dtype=self.dtype, device=self.device)
        kff, Kfb = [None] * N, [None] * N
        for k in reversed(range(N)):
            Vd = Vx + Vxx @ d[k]
            Qx = lx[k] + A[k].T @ Vd
            Qu = lu[k] + B[k].T @ Vd
            Qxx = lxx[k] + A[k].T @ Vxx @ A[k]
            Quu = luu[k] + B[k].T @ Vxx @ B[k]
            Qux = lux[k] + B[k].T @ Vxx @ A[k]
            H = 0.5 * (Quu + Quu.T) + reg
            k_, K_ = -torch.linalg.solve(H, Qu), -torch.linalg.solve(H, Qux)
            Vx = Qx + K_.T @ Quu @ k_ + K_.T @ Qu + Qux.T @ k_
            Vxx = Qxx + K_.T @ Quu @ K_ + K_.T @ Qux + Qux.T @ K_
            Vxx = 0.5 * (Vxx + Vxx.T)
            kff[k], Kfb[k] = k_, K_

        # the line search: every step length's rollout of the LQ model
        best = None
        for a in SQP["alphas"]:
            dx_k = torch.zeros(30, dtype=self.dtype, device=self.device)
            Xs, Ws = [X[0]], []
            for k in range(N):
                dw = a * kff[k] + Kfb[k] @ dx_k
                Ws.append(W[k] + dw)
                dx_k = A[k] @ dx_k + B[k] @ dw + a * d[k]
                Xs.append(X[k + 1] + dx_k)
            Xc, Wc = torch.stack(Xs), torch.stack(Ws)
            c, dc = merit(Xc, Wc)
            v = dc.abs().sum()
            ok = bool(torch.isfinite(c)) and bool(torch.isfinite(v))
            # the filter: above g_max a step has to cut the violation;
            # below, the cost, the violation kept within the corridor
            if vio <= SQP["g_max"]:
                accept = ok and c < cost and v <= max(float(vio)
                                                      + SQP["g_min"],
                                                      SQP["g_max"])
                score = c
            else:
                accept = ok and v < (1 - 1e-4) * vio
                score = v
            if accept and (best is None or score < best[0]):
                best = (score, Xc, Wc, c)
        if best is not None:
            _, X, W, cost = best
        U = input_of(X[:-1], W)
        U = torch.cat([U, U[-1:]])
        return Policy(tn, X, U, modes, cost, W)
