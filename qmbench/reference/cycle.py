"""One control period of the closed-loop fleet for the plain reference:
the reference controller's MPC period (upstream qm_control,
QMController.cpp:128-190 and :286-334) over the simulated robot
(qm_gazebo QMHWSim.cpp:98-171), written from those semantics:

- the observation from the plant's ground truth (the simulation's state
  estimate: base pose and twist as the plant has them), with the yaw
  unwrapped against the last period's observation (QMController.cpp:
  239-242);
- one SQP iteration of the MPC (mpc.py) from the carried warm start,
  shifted onto the new horizon by one MPC period;
- the MRT's one-period lag: the period's ticks execute the policy of the
  previous period, and the fresh policy waits in the buffer for the next
  period;
- `ticks` control ticks, each: the executed policy evaluated at the
  tick's time, the whole-body controller (wbc.py) on the plant's state,
  the hybrid joint law (QMController::updateControlLaw :177-190; legs:
  the planned joint velocities, kp 0, kd LEG_KD; arm: position and
  velocity 0 gains ARM_KP, ARM_KD; the WBC's torques as feed-forward),
  then one step of the plant (hardware.py).

Departures from upstream, each forced by running a period in lockstep:
- the MPC and the ticks run in one thread one after the other; upstream
  runs the MPC on its own thread and the ticks read the newest policy the
  MRT holds, which the one-period lag stands for;
- the safety checker is not run: the benchmark counts the fleet's own
  safety flags, and a period that trips it has no reference answer;
- the solve's node times and the gait's switching times lie on the grid
  of the configuration's float32 clock: in most periods a node lands on a
  switching time in decimal arithmetic (0.01 j + 0.015 k = 0.35 m), and
  only the clock's rounding puts it on one side; the reference takes the
  side that the deployed float32 controller takes.

A period's state is a dict of tensors: q, v (24), anchors (4, 2), W (N,
30) and X (N+1, 30) the warm start, u_last (30) the last tick's input, yaw
the last observation's yaw, t the controller time, and policy, the
executed policy as (t_nodes, X, U, modes, cost, W). Nothing here comes
from the port.
"""
import math

import numpy as np
import torch

from .hardware import ARM_KD, ARM_KP, LEG_KD, PLANT, Plant
from .mpc import Mpc, Policy, Schedule, contact_flags
from .robot import cross, euler_rate_matrix, euler_zyx_to_R
from .wbc import GAINS, wbc

# a configuration's names of the settings that this period hard-codes
_PLANT = dict(sim_dt="dt", contact_kp="kp", contact_kd="kd",
              friction_mu="mu", tangential_kp="kt", tangential_kd="dtan",
              joint_damping="joint_damping")
_GAINS = dict(kp_swing=("swing", 0), kd_swing=("swing", 1),
              base_height_kp=("height", 0), base_height_kd=("height", 1),
              kp_base_linear=("base_lin", 0), kd_base_linear=("base_lin", 1),
              kp_base_angular=("base_ang", 0),
              kd_base_angular=("base_ang", 1), kp_ee_linear=("ee_lin", 0),
              kd_ee_linear=("ee_lin", 1), kp_ee_angular=("ee_ang", 0),
              kd_ee_angular=("ee_ang", 1))


def check_config(cfg):
    """Refuse a configuration whose period this module does not run: the
    plant, the hybrid law's gains, the WBC's gains, the one-period lag and
    no actuation delay are written here."""
    g = cfg["wbc_gains"]
    want = [(cfg["plant"][k], PLANT[v]) for k, v in _PLANT.items()]
    want += [(cfg["plant"]["delay_steps"], 0), (cfg["mrt_policy_lag"], 1),
             (cfg["leg_kd"], LEG_KD), (g["kp_arm_wbc"], ARM_KP),
             (g["kd_arm_wbc"], ARM_KD),
             (g["swing_task_weight"], GAINS["swing_weight"]),
             (g["friction_coefficient"], GAINS["friction"])]
    want += [(g[k], GAINS[n][j]) for k, (n, j) in _GAINS.items()]
    if any(float(a) != float(b) for a, b in want):
        raise ValueError("the reference's control period has other "
                         "settings than the configuration's")


def f32_schedule(events, modes):
    """A Schedule whose switching times are the float32 clock's values."""
    return Schedule([float(np.float32(e)) for e in events], modes)


class _ClockMpc(Mpc):
    """The MPC with its node times on the float32 clock's grid: t + dt k
    rounded as float32 arithmetic rounds it."""

    def nodes(self, t, schedule):
        f32 = torch.float32
        k = torch.arange(self.N + 1, dtype=f32, device=self.device)
        tn = (t.to(f32) + np.float32(self.dt) * k).to(self.dtype)
        modes = schedule.mode_at(tn)
        flags = contact_flags(modes).to(self.dtype)
        end = float(np.float32(np.float32(float(t)) + np.float32(
            self.horizon)))
        zdot = torch.stack([schedule.swing_zdot(f, tn, end)
                            for f in range(4)], -1)
        return tn, modes, flags, zdot


class Cycle:
    """The control period of one scenario, in the robot's dtype and on its
    device."""

    def __init__(self, robot, info, horizon, dt, control_freq, mpc_freq,
                 substeps=1):
        self.robot, self.info = robot, info
        self.mpc = _ClockMpc(robot, info, horizon, dt)
        self.ticks = int(round(control_freq / mpc_freq))
        self.tick_dt = 1.0 / control_freq
        self.period = 1.0 / mpc_freq
        self.substeps = substeps
        if abs(substeps * PLANT["dt"] * control_freq - 1.0) > 1e-9:
            raise ValueError("a tick is a whole number of plant steps")
        # float32 products in full float32 on the card (the control turns
        # TF32 on after it has built its reference)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _t(self, a):
        return torch.as_tensor(a).to(dtype=self.robot.dtype,
                                     device=self.robot.device)

    def observe(self, q, v, last_yaw):
        """The centroidal observation (30) of the plant's state: the
        centre of mass's velocity, the angular momentum over the mass
        (single rigid body at the nominal inertia), the pose with its yaw
        unwrapped to within pi of last_yaw, the joints."""
        info = self.info
        yaw = q[3] + 2.0 * math.pi * torch.round((last_yaw - q[3])
                                                 / (2.0 * math.pi))
        zyx = torch.cat([yaw[None], q[4:6]])
        R = euler_zyx_to_R(zyx)
        w = euler_rate_matrix(zyx) @ v[3:6]
        Iw = R @ info.I_com @ R.T
        return torch.cat([v[:3] + cross(w, R @ info.r_com),
                          Iw @ w / info.mass, q[:3], zyx, q[6:]])

    def start(self, q0, target, schedule):
        """The state after the controller's start: the plant at rest at
        q0, the warm start the weight spread over four feet and the state
        held, then one solve that does not advance the plant (the
        starting() handshake, QMController.cpp:98-126)."""
        q0 = self._t(q0)
        N = self.mpc.N
        x0 = self.observe(q0, torch.zeros_like(q0), q0[3])
        W0 = self.mpc.ocp.u_ref(torch.ones(4, dtype=torch.int64,
                                           device=q0.device))
        plant = Plant(self.robot, q0)
        p = self.mpc.solve(0.0, x0, target, schedule, W0.expand(N, 30),
                           x0.expand(N + 1, 30), 0.0)
        return dict(q=plant.q, v=plant.v, anchors=plant.anchors, W=p.W,
                    X=p.X, u_last=torch.zeros(30).to(q0), yaw=q0[3],
                    t=0.0, policy=(p.t_nodes, p.X, p.U, p.modes, p.cost,
                                   p.W))

    def run(self, st, target, schedule):
        """(the state one period later, {"cost", "X": the fresh policy's,
        "tau": the last tick's WBC torques (18)})."""
        on = self._t
        q, v = on(st["q"]), on(st["v"])
        t = float(st["t"])
        x = self.observe(q, v, on(st["yaw"]))
        fresh = self.mpc.solve(t, x, target, schedule, on(st["W"]),
                               on(st["X"]), self.period)
        executed = Policy(*[on(a) if a.is_floating_point() else a.cpu()
                            for a in st["policy"]])
        plant = Plant(self.robot, q, v, on(st["anchors"]))
        u_last = on(st["u_last"])
        zero6 = torch.zeros(6).to(q)
        kp = torch.cat([torch.zeros(12).to(q), ARM_KP + zero6])
        kd = torch.cat([LEG_KD + torch.zeros(12).to(q), ARM_KD + zero6])
        for _ in range(self.ticks):
            x_des, u_des, mode = executed.at(on(t))
            flags = contact_flags(torch.tensor(mode)).to(q.device)
            tau = wbc(self.robot, self.mpc.ocp, self.robot.effort, x_des,
                      u_des, u_last, plant.q, plant.v, flags, self.tick_dt)
            for _ in range(self.substeps):
                plant.step(x_des[12:30], torch.cat([u_des[12:24], zero6]),
                           kp, kd, tau)
            u_last = u_des
            t += self.tick_dt
        new = dict(q=plant.q, v=plant.v, anchors=plant.anchors, W=fresh.W,
                   X=fresh.X, u_last=u_last, yaw=x[9], t=t,
                   policy=(fresh.t_nodes, fresh.X, fresh.U, fresh.modes,
                           fresh.cost, fresh.W))
        return new, dict(cost=fresh.cost, X=fresh.X, tau=tau)
