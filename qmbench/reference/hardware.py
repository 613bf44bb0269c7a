"""One robot's control loop for the plain reference: the simulated robot
(rigid-body dynamics, compliant ground with sticking friction, hybrid
joint commands; upstream qm_gazebo QMHWSim.cpp:98-171), the IMU estimator
(the first orientation sample latched as the offset, StateEstimateBase.cpp:
46-68) and the controller's tick (read, estimate, solve every
ticks_per_mpc-th tick, the WBC, write; QMController.cpp:286-334), written
from those semantics. Nothing here comes from the port.
"""
import torch

from .mpc import Mpc, contact_flags
from .robot import (FEET, Centroidal, Robot, R_to_euler_zyx, R_to_quat,
                    cross, euler_rate_matrix, euler_zyx_to_R, quat_to_R)
from .wbc import wbc

PLANT = dict(dt=0.001, kp=40000.0, kd=2000.0, mu=0.7, kt=20000.0, dtan=400.0,
             joint_damping=0.1)
LEG_KD, ARM_KP, ARM_KD = 3.0, 0.0, 0.5


class Plant:
    """q, v (24) and the friction anchors (4, 2) of the feet."""

    def __init__(self, robot: Robot, q, v=None, anchors=None):
        self.robot = robot
        self.q = q
        self.v = torch.zeros_like(q) if v is None else v
        self.anchors = robot.feet(q)[:, :2] if anchors is None else anchors

    def step(self, pos_des, vel_des, kp, kd, ff):
        """One millisecond of semi-implicit Euler; the contact and joint
        damping and the command's position gain are taken implicitly."""
        P, robot, q, v = PLANT, self.robot, self.q, self.v
        dt = P["dt"]
        kin = robot.fk(q)
        Jc = torch.cat([robot.frame_jacobian(kin, f)[:3] for f in FEET])
        p = torch.stack([robot.frame(kin, f)[0] for f in FEET])
        vel = (Jc @ v).reshape(4, 3)
        depth = torch.clamp(-p[:, 2], min=0.0)
        on = (depth > 0).to(q.dtype)
        fn = torch.clamp(P["kp"] * depth - P["kd"] * vel[:, 2] * on, min=0.0)
        ft = -P["kt"] * (p[:, :2] - self.anchors) - P["dtan"] * vel[:, :2]
        cap = torch.clamp(P["mu"] * fn / (torch.linalg.vector_norm(ft, dim=1)
                                          + 1e-9), max=1.0)
        ft = ft * cap[:, None]
        anchors = torch.where(on[:, None] > 0, p[:, :2] + (
            ft + P["dtan"] * vel[:, :2]) / P["kt"], p[:, :2])
        fc = torch.cat([ft, fn[:, None]], 1) * on[:, None]
        damp = torch.stack([P["dtan"] * on, P["dtan"] * on, P["kd"] * on],
                           1).reshape(-1)
        qj, vj = q[6:], v[6:]
        tau = torch.cat([torch.zeros(6).to(q),
                         kp * (pos_des - qj) + kd * (vel_des - vj) + ff])
        z6 = torch.zeros(6).to(q)
        rhs = tau - robot.bias(q, v, kin) + Jc.T @ fc.reshape(-1) \
            - torch.cat([z6, (P["joint_damping"] + dt * kp) * vj])
        Mi = robot.mass_matrix(q, kin) + dt * (Jc.T * damp) @ Jc \
            + dt * torch.diag(torch.cat([z6, P["joint_damping"] + kd
                                         + dt * kp]))
        vdot = torch.linalg.solve(Mi, rhs)
        self.v = v + dt * vdot
        self.q = q + dt * self.v
        self.anchors = anchors


class Loop:
    """The tick of the hardware loop with its MPC inline, over the
    simulated robot."""

    def __init__(self, robot: Robot, info: Centroidal, q0, horizon, dt,
                 control_freq, mpc_freq, substeps):
        self.robot, self.info = robot, info
        self.mpc = Mpc(robot, info, horizon, dt)
        self.plant = Plant(robot, torch.as_tensor(q0).to(robot.dtype).to(
            robot.device))
        self.tick_dt = 1.0 / control_freq
        self.every = int(round(control_freq / mpc_freq))
        self.substeps = substeps
        self.offset = None
        self.policy = self.W = self.X = self.t_prev = None
        self.u_last = torch.zeros(30, dtype=robot.dtype, device=robot.device)
        self.t, self.k = 0.0, 0

    def observe(self):
        """The IMU estimate and the centroidal observation (30)."""
        q, v = self.plant.q, self.plant.v
        R = euler_zyx_to_R(q[3:6])
        quat = R_to_quat(R)
        gyro = R.T @ (euler_rate_matrix(q[3:6]) @ v[3:6])
        raw = R_to_euler_zyx(quat_to_R(quat))
        if self.offset is None:
            self.offset = raw
        zyx = raw - self.offset
        zyx_dot = torch.linalg.solve(euler_zyx_to_R(raw).T
                                     @ euler_rate_matrix(raw), gyro)
        qe = torch.cat([q[:3], zyx, q[6:]])
        ve = torch.cat([v[:3], zyx_dot, v[6:]])
        Rz = euler_zyx_to_R(zyx)
        w = euler_rate_matrix(zyx) @ zyx_dot
        r = Rz @ self.info.r_com
        Iw = Rz @ self.info.I_com @ Rz.T
        x = torch.cat([ve[:3] + cross(w, r), Iw @ w / self.info.mass, qe])
        return qe, ve, x

    def tick(self, target, schedule):
        qe, ve, x = self.observe()
        if self.policy is None or self.k % self.every == 0:
            shift = 0.0 if self.t_prev is None else self.t - self.t_prev
            self.policy = self.mpc.solve(self.t, x, target, schedule,
                                         self.W, self.X, shift)
            self.W, self.X, self.t_prev = self.policy.W, self.policy.X, self.t
        x_des, u_des, mode = self.policy.at(torch.as_tensor(
            self.t, dtype=self.robot.dtype, device=self.robot.device))
        flags = contact_flags(torch.tensor(mode))
        tau = wbc(self.robot, self.mpc.ocp, self.robot.effort, x_des,
                  u_des, self.u_last, qe, ve, flags.to(self.robot.device),
                  self.tick_dt)
        self.u_last = u_des
        o = torch.zeros(6).to(tau)
        kp = torch.cat([torch.zeros(12).to(tau), ARM_KP + o])
        kd = torch.cat([LEG_KD + torch.zeros(12).to(tau), ARM_KD + o])
        for _ in range(self.substeps):
            self.plant.step(x_des[12:30], torch.cat([u_des[12:24], o]), kp,
                            kd, tau)
        self.t += self.tick_dt
        self.k += 1
        return tau, x
