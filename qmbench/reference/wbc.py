"""The whole-body controller of the plain reference (upstream qm_control,
qm_wbc/src/HierarchicalWbc.cpp:18-44 and WbcBase.cpp:25-595), written from
those semantics: x = [v_dot (24); contact forces (12)],

  level 0: the floating base's equations of motion, the torque limits,
           the stance feet held still, the friction pyramids (swing feet
           carry no force);
  level 1: base height, base orientation, end-effector position and
           orientation, and 100 x the swing feet's Cartesian servo;
  level 2: the MPC's contact forces and the base's xy servo,

solved lexicographically: each level is a regularized least-squares
problem (ridge 3e-6 of its largest curvature) in the damped null space of
the levels above it, under the level-0 inequalities (their slacks carried
down), each solved to convergence by a textbook primal-dual interior
point method. Nothing here comes from the port.
"""
import torch
from torch.func import jvp

from .robot import (EE, FEET, Robot, euler_rate_matrix, euler_zyx_to_R, mv,
                    so3_log)

GAINS = dict(swing=(350.0, 37.0), height=(400.0, 140.0),
             base_lin=(400.0, 100.0), base_ang=(400.0, 140.0),
             ee_lin=(3000.0, 75.0), ee_ang=(2000.0, 75.0), swing_weight=100.0,
             friction=0.3)
RIDGE, NULL_DAMP, INACTIVE = 3e-6, 1e-7, 5e5


def _kinematics(robot: Robot, q):
    """The frame Jacobians the tasks read, stacked: 12 foot rows, 6 base
    rows, 6 end-effector rows (24, 24)."""
    kin = robot.fk(q)
    return torch.cat([robot.frame_jacobian(kin, f)[..., :3, :] for f in FEET]
                     + [robot.frame_jacobian(kin, "base"),
                        robot.frame_jacobian(kin, EE)], -2)


def measured(robot: Robot, q, v, flags):
    kin = robot.fk(q)
    # with a leading axis of one: forward-mode tangents of 0-dim tensors
    # may widen to float64, which a float32 run (the control) refuses
    J, Jdot = (a[0] for a in jvp(lambda qq: _kinematics(robot, qq),
                                 (q[None],), (v[None],)))
    feet = torch.stack([robot.frame(kin, f)[0] for f in FEET])
    ee_p, ee_R = robot.frame(kin, EE)
    Jdv = Jdot @ v
    Jdot_ang = Jdot[21:24].clone()
    Jdot_ang[:, 3:6] = 0.0
    return dict(q=q, v=v, M=robot.mass_matrix(q, kin),
                h=robot.bias(q, v, kin), Jc=J[:12], dJc_v=Jdv[:12],
                base_J=J[12:18], base_dJ_v=Jdv[12:18], ee_J=J[18:24],
                ee_dJ_v=Jdv[18:24], ee_dJ_v_noeuler=Jdot_ang @ v,
                feet=feet, feet_vel=(J[:12] @ v).reshape(4, 3), ee_p=ee_p,
                ee_R=ee_R, ee_vel=J[18:24] @ v, flags=flags)


def desired(robot: Robot, ocp, x_des, u_des, u_last, period):
    """The MPC's plan at this tick as the tasks read it: the base
    acceleration from the plan's momentum rate (A_b^-1 (h_dot - A_dot v -
    A_j qdd_j), joint accelerations differenced from the last input), the
    planned feet and end-effector."""
    q = x_des[6:30]
    v = torch.cat([ocp.base_rates(x_des), u_des[12:30]])
    qdd = (u_des[12:] - u_last[12:]) / period
    A, Adot = (a[0] for a in jvp(robot.momentum_matrix, (q[None],),
                                 (v[None],)))
    hdot = ocp.flow(x_des, u_des)[:6] * ocp.info.mass
    rate = hdot - Adot @ v - A[:, 6:] @ qdd
    base_acc = torch.linalg.solve(A[:, :6], rate)
    kin = robot.fk(q)
    J = _kinematics(robot, q)
    ee_p, ee_R = robot.frame(kin, EE)
    return dict(q=q, v=v, base_acc=base_acc,
                feet=torch.stack([robot.frame(kin, f)[0] for f in FEET]),
                feet_vel=(J[:12] @ v).reshape(4, 3), ee_p=ee_p, ee_R=ee_R,
                ee_vel=J[18:24] @ v)


def levels(m, d, tau_max):
    """((A0, b0, D, f), (A1, b1), (A2, b2))."""
    q = m["q"]
    z = lambda r, c: torch.zeros(r, c, dtype=q.dtype, device=q.device)  # noqa
    c = m["flags"].to(q.dtype)
    stance3, swing3 = c.repeat_interleave(3), (1 - c).repeat_interleave(3)
    M, h, Jc = m["M"], m["h"], m["Jc"]
    # level 0
    eom = torch.cat([M[:6], -Jc.T[:6]], 1)
    still = torch.cat([Jc, z(12, 12)], 1) * stance3[:, None]
    free = torch.cat([z(12, 24), torch.diag(swing3)], 1)
    A0 = torch.cat([eom, still, free])
    b0 = torch.cat([-h[:6], -m["dJc_v"] * stance3,
                    torch.zeros(12, dtype=q.dtype, device=q.device)])
    Aj = torch.cat([M[6:], -Jc.T[6:]], 1)
    mu = GAINS["friction"]
    pyr = torch.tensor([[0.0, 0.0, -1.0], [1.0, 0.0, -mu], [-1.0, 0.0, -mu],
                        [0.0, 1.0, -mu], [0.0, -1.0, -mu]], dtype=q.dtype,
                       device=q.device)
    cone = torch.block_diag(*[pyr] * 4) * c.repeat_interleave(5)[:, None]
    D = torch.cat([Aj, -Aj, torch.cat([z(20, 24), cone], 1)])
    f = torch.cat([tau_max - h[6:], tau_max + h[6:],
                   (1 - c).repeat_interleave(5) * 1e6])
    # level 1
    kp, kd = GAINS["height"]
    sel = lambda i: torch.nn.functional.one_hot(  # noqa
        torch.tensor(i), 36).to(q)
    rows, rhs = [sel(2)[None]], [(d["base_acc"][2] + kp * (d["q"][2] - q[2])
                                  + kd * (d["v"][2] - m["v"][2]))[None]]
    kp, kd = GAINS["base_ang"]
    zyx = q[3:6]
    E = euler_rate_matrix(zyx)
    err = so3_log(euler_zyx_to_R(d["q"][3:6]) @ euler_zyx_to_R(zyx).T)
    _, Edot_v = jvp(lambda zz: mv(euler_rate_matrix(zz), d["v"][3:6]),
                    (zyx[None],), (d["v"][3:6][None],))
    Edot_v = Edot_v[0]
    acc = E @ d["base_acc"][3:6] + Edot_v
    rows.append(torch.cat([m["base_J"][3:], z(3, 12)], 1))
    rhs.append(acc + kp * err + kd * (E @ d["v"][3:6] - E @ m["v"][3:6])
               - m["base_dJ_v"][3:])
    kp, kd = GAINS["ee_lin"]
    rows.append(torch.cat([m["ee_J"][:3], z(3, 12)], 1))
    rhs.append(kp * (d["ee_p"] - m["ee_p"]) + kd * (d["ee_vel"][:3]
                                                   - m["ee_vel"][:3])
               - m["ee_dJ_v"][:3])
    kp, kd = GAINS["ee_ang"]
    Jang = m["ee_J"][3:].clone()
    Jang[:, 3:6] = 0.0
    rows.append(torch.cat([Jang, z(3, 12)], 1))
    rhs.append(kp * so3_log(d["ee_R"] @ m["ee_R"].T) - kd * m["ee_vel"][3:]
               - m["ee_dJ_v_noeuler"])
    kp, kd = GAINS["swing"]
    w = GAINS["swing_weight"]
    acc = (kp * (d["feet"] - m["feet"])
           + kd * (d["feet_vel"] - m["feet_vel"])).reshape(-1)
    rows.append(w * torch.cat([Jc, z(12, 12)], 1) * swing3[:, None])
    rhs.append(w * (acc - m["dJc_v"]) * swing3)
    A1, b1 = torch.cat(rows), torch.cat(rhs)
    # level 2
    kp, kd = GAINS["base_lin"]
    A2 = torch.cat([torch.cat([z(12, 24), torch.eye(12).to(q)], 1),
                    torch.stack([sel(0), sel(1)])])
    b2 = torch.cat([d["u_des"][:12], d["base_acc"][:2]
                    + kp * (d["q"][:2] - q[:2]) + kd * (d["v"][:2]
                                                        - m["v"][:2])])
    return (A0, b0, D, f), (A1, b1), (A2, b2)


def qp(H, c, G, h, iters=60):
    """min 0.5 x'Hx + c'x s.t. G x <= h, H positive definite: Mehrotra's
    primal-dual interior point method, until its residuals and the duality
    gap fall to the dtype's rounding; the best iterate by those."""
    m = G.shape[0]
    tol = max(1e-12, 50 * torch.finfo(H.dtype).eps)
    x, info = torch.linalg.solve_ex(H, -c)
    if int(info) != 0:
        x = torch.zeros_like(c)
    s = torch.clamp(h - G @ x, min=1.0)
    lam = torch.ones(m, dtype=H.dtype, device=H.device)
    scale = max(1.0, float(torch.linalg.vector_norm(c)))

    def step(v, dv):
        neg = dv < 0
        if not bool(neg.any()):
            return 1.0
        return min(1.0, float((-v[neg] / dv[neg]).min()))

    best = None
    for _ in range(iters):
        rd = H @ x + c + G.T @ lam
        rp = G @ x + s - h
        mu = float(s @ lam) / m
        err = max(float(rd.abs().max()), float(rp.abs().max()), mu) / scale
        if best is None or err < best[0]:
            best = (err, x)
        if err < tol or not err == err:
            break
        D = lam / s
        K = H + G.T @ (D[:, None] * G)

        def direction(rc):
            dx, info = torch.linalg.solve_ex(
                K, -rd + G.T @ ((rc - lam * rp) / s))
            ds = -rp - G @ dx
            return dx, ds, (-rc - lam * ds) / s, int(info) == 0
        dx, ds, dl, ok = direction(s * lam)
        if not ok:          # float32 past its rounding: keep the best
            break
        ap, ad = step(s, ds), step(lam, dl)
        mu_aff = float((s + ap * ds) @ (lam + ad * dl)) / m
        sigma = (mu_aff / mu) ** 3
        dx, ds, dl, ok = direction(s * lam + ds * dl - sigma * mu)
        if not ok:
            break
        ap, ad = 0.99 * step(s, ds), 0.99 * step(lam, dl)
        x, s, lam = x + ap * dx, s + ap * ds, lam + ad * dl
    return best[1]


def cascade(level0, level1, level2):
    """The lexicographic solution x (36) of the three levels."""
    A0, b0, D, f = level0
    n = A0.shape[1]
    eye = torch.eye(n, dtype=A0.dtype, device=A0.device)
    act = f < INACTIVE
    Da, fa = D[act], f[act]
    ma = Da.shape[0]

    def objective(A, b, Z, x):
        Az = A @ Z
        g = Az.T @ Az
        return Az, g + RIDGE * (g.diagonal().max() + 1e-3) * eye, \
            Az.T @ (A @ x - b)

    def null(Az):
        gram = Az @ Az.T
        lam = NULL_DAMP * (gram.diagonal().sum() / Az.shape[0] + 1.0)
        return eye - Az.T @ torch.linalg.solve(
            gram + lam * torch.eye(Az.shape[0], dtype=A0.dtype,
                                   device=A0.device), Az)

    # level 0, with a slack v >= 0 on every inequality: D z - v <= f
    x = torch.zeros(n, dtype=A0.dtype, device=A0.device)
    Az, Hz, cz = objective(A0, b0, eye, x)
    H = torch.block_diag(Hz, torch.eye(ma).to(A0))
    c = torch.cat([cz, torch.zeros(ma).to(A0)])
    Im = torch.eye(ma).to(A0)
    G = torch.cat([torch.cat([torch.zeros(ma, n).to(A0), -Im], 1),
                   torch.cat([Da, -Im], 1)])
    y = qp(H, c, G, torch.cat([torch.zeros(ma).to(A0), fa]))
    x, v = y[:n], y[n:]
    Z = null(Az)
    for A, b in (level1, level2):
        Az, Hz, cz = objective(A, b, Z, x)
        hq = torch.clamp(fa - Da @ x + v, min=0.0)
        zs = qp(Hz, cz, Da @ Z, hq)
        x = x + Z @ zs
        Z = Z @ null(Az)
    return x


def torques(m, x):
    """tau = M_j vdot - Jc_j' F + h_j."""
    return m["M"][6:] @ x[:24] - m["Jc"].T[6:] @ x[24:] + m["h"][6:]


def wbc(robot, ocp, tau_max, x_des, u_des, u_last, q, v, flags, period):
    m = measured(robot, q, v, flags)
    d = desired(robot, ocp, x_des, u_des, u_last, period)
    d["u_des"] = u_des
    return torques(m, cascade(*levels(m, d, tau_max)))
