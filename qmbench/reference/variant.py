"""One control period of upstream's MPC-only controller (QMMpcController,
qm_controllers/src/QMController.cpp:368-445) for the plain reference,
written from those semantics over the simulated robot (hardware.py):

- the observation from the plant's ground truth, the yaw unwrapped
  against the last period's (as cycle.py);
- one SQP iteration of the MPC (mpc.py) from the carried warm start,
  shifted onto the new horizon by one MPC period; the period's ticks
  execute this fresh policy (no MRT lag);
- the arm command at the MPC rate (:436-443): the policy's state at the
  period's start plus its arm joint velocities integrated over 10 ms,
  cmd_j = x(24 + j) + u(24 + j) / 100;
- `ticks` control ticks, each: the policy at the tick's time; the
  MPC-only whole-body controller (HierarchicalMpcWbc.cpp:18-34) on the
  plant's state, its three levels each solved to convergence by
  wbc.py's cascade; the hybrid joint law (:405-431: legs at the planned
  joint positions and velocities, kp 0, kd LEG_KD, the WBC's torques as
  feed-forward; the arm under the simulator's position PIDs,
  qm_gazebo/config/position_control.yaml, toward the arm command, no
  feed-forward); `substeps` plant steps.

The MPC-only levels:
  level 0: the floating base's equations of motion, the torque limits,
           the stance feet held still, the friction pyramids (wbc.py's);
  level 1: base height, base orientation, the base's xy servo, and 100 x
           the swing feet's Cartesian servo;
  level 2: the MPC's contact forces.

A period's state is cycle.py's without the executed policy. Nothing here
comes from the port.
"""
import torch

from .cycle import _GAINS, _PLANT, Cycle
from .hardware import LEG_KD, PLANT, Plant
from .mpc import contact_flags
from .robot import Robot
from .wbc import GAINS, cascade, desired, levels, measured, torques

ARM_POS_KP = (5000.0, 5000.0, 5000.0, 500.0, 500.0, 500.0)
ARM_POS_KD = (8.0, 8.0, 8.0, 0.2, 0.2, 0.2)
ARM_CMD_PERIOD = 1.0 / 100.0

# the rows of wbc.py's whole-body levels that the MPC-only levels take:
# level 1 there is base height (1), base orientation (3), the EE's
# position (3) and orientation (3), the swing feet (12); level 2 the
# contact forces (12) and the base's xy servo (2)
_HEIGHT_ANG, _SWING, _FORCES, _BASE_XY = (slice(0, 4), slice(10, 22),
                                          slice(0, 12), slice(12, 14))


def check_config(cfg):
    """Refuse a configuration whose period this module does not run: the
    plant, the hybrid law's gains, the WBC's gains, the fresh policy and
    no actuation delay are written here."""
    g = cfg["wbc_gains"]
    want = [(cfg["plant"][k], PLANT[v]) for k, v in _PLANT.items()]
    want += [(cfg["plant"]["delay_steps"], 0), (cfg["mrt_policy_lag"], 0),
             (cfg["leg_kd"], LEG_KD),
             (g["swing_task_weight"], GAINS["swing_weight"]),
             (g["friction_coefficient"], GAINS["friction"])]
    want += [(g[k], GAINS[n][j]) for k, (n, j) in _GAINS.items()]
    want += [(cfg["arm_cmd_period"], ARM_CMD_PERIOD)]
    want += list(zip(cfg["arm_pos_kp"], ARM_POS_KP))
    want += list(zip(cfg["arm_pos_kd"], ARM_POS_KD))
    if any(float(a) != float(b) for a, b in want):
        raise ValueError("the reference's control period has other "
                         "settings than the configuration's")


def mpc_levels(m, d, tau_max):
    """((A0, b0, D, f), (A1, b1), (A2, b2)) of the MPC-only stack."""
    level0, (A1, b1), (A2, b2) = levels(m, d, tau_max)
    rows = (A1[_HEIGHT_ANG], A2[_BASE_XY], A1[_SWING])
    rhs = (b1[_HEIGHT_ANG], b2[_BASE_XY], b1[_SWING])
    return level0, (torch.cat(rows), torch.cat(rhs)), (A2[_FORCES],
                                                      b2[_FORCES])


def stack(robot: Robot, ocp, tick):
    """(WBC data, MPC-only levels) of one tick's inputs: a dict of x_des,
    u_des, u_last (30), q, v (24), flags (4) and the tick's period."""
    m = measured(robot, tick["q"], tick["v"], tick["flags"])
    d = desired(robot, ocp, tick["x_des"], tick["u_des"], tick["u_last"],
                tick["period"])
    d["u_des"] = tick["u_des"]
    return m, mpc_levels(m, d, robot.effort)


def objectives(lv, x):
    """Per-level objectives at x: level 0's 0.5 |A0 x - b0|^2 + 0.5 |v|^2
    with v = max(0, D x - f) the least slack, then each lower level's
    residual norm |A x - b|."""
    (A0, b0, D, f), (A1, b1), (A2, b2) = lv
    v = torch.clamp(D @ x - f, min=0.0)
    return [float(0.5 * (A0 @ x - b0) @ (A0 @ x - b0) + 0.5 * v @ v),
            float(torch.linalg.vector_norm(A1 @ x - b1)),
            float(torch.linalg.vector_norm(A2 @ x - b2))]


class Variant(Cycle):
    """The MPC-only controller's period of one robot, in the robot's
    dtype and on its device."""

    def start(self, q0, target, schedule, solves=1):
        """The state after the controller's start: the plant at rest at
        q0, the warm start the weight spread over four feet and the state
        held, then `solves` solves that do not advance the plant."""
        st = super().start(q0, target, schedule)
        x0 = self.observe(st["q"], st["v"], st["yaw"])
        for _ in range(solves - 1):
            p = self.mpc.solve(0.0, x0, target, schedule, st["W"], st["X"],
                               0.0)
            st.update(W=p.W, X=p.X)
        st.pop("policy")
        return st

    def run(self, st, target, schedule):
        """(the state one period later, {"cost", "X": the fresh policy's,
        "arm_cmd" (6), "tau": the last tick's leg torques (12), "tick":
        the last tick's WBC inputs (stack's) with "x", its solution})."""
        on = self._t
        q, v = on(st["q"]), on(st["v"])
        t = float(st["t"])
        x = self.observe(q, v, on(st["yaw"]))
        fresh = self.mpc.solve(t, x, target, schedule, on(st["W"]),
                               on(st["X"]), self.period)
        x_now, u_now, _ = fresh.at(on(t))
        arm_cmd = x_now[24:30] + u_now[24:30] * ARM_CMD_PERIOD
        plant = Plant(self.robot, q, v, on(st["anchors"]))
        u_last = on(st["u_last"])
        zero6 = torch.zeros(6).to(q)
        kp = torch.cat([torch.zeros(12).to(q), torch.tensor(ARM_POS_KP)
                        .to(q)])
        kd = torch.cat([LEG_KD + torch.zeros(12).to(q),
                        torch.tensor(ARM_POS_KD).to(q)])
        for _ in range(self.ticks):
            x_des, u_des, mode = fresh.at(on(t))
            tick = dict(x_des=x_des, u_des=u_des, u_last=u_last, q=plant.q,
                        v=plant.v, period=self.tick_dt,
                        flags=contact_flags(torch.tensor(mode)).to(q))
            m, lv = stack(self.robot, self.mpc.ocp, tick)
            tick["x"] = cascade(*lv)
            tau = torques(m, tick["x"])
            for _ in range(self.substeps):
                plant.step(torch.cat([x_des[12:24], arm_cmd]),
                           torch.cat([u_des[12:24], zero6]), kp, kd,
                           torch.cat([tau[:12], zero6]))
            u_last = u_des
            t += self.tick_dt
        new = dict(q=plant.q, v=plant.v, anchors=plant.anchors, W=fresh.W,
                   X=fresh.X, u_last=u_last, yaw=x[9], t=t)
        return new, dict(cost=fresh.cost, X=fresh.X, arm_cmd=arm_cmd,
                         tau=tau[:12], tick=tick)
