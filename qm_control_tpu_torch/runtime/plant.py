"""Physics plant (port of qm_control_tpu/runtime/plant.py): full rigid-body
dynamics, compliant ground contact with anchor-spring (sticking) friction,
and hybrid-joint actuation through a command delay line (reference
qm_gazebo/src/QMHWSim.cpp:98-116).

State is a NamedTuple of tensors; every update returns a new state (no
in-place writes), and nothing is read back to the host, so a tick stays
asynchronous on the card.

`plant_write` is one write of the hardware seam (push_command, then the
substeps); `SimHardware.write` replays it as CUDA graphs on the card
(utils/graphs.py), so the host dispatches the write's ~2.9k eager ops
once per input signature instead of once per write.
"""
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..models import dynamics as D
from ..models import kinematics as K
from ..models.spec import CONTACT_FRAMES, EE_FRAME, NQ, NUM_JOINTS, RobotModel
from ..utils.graphs import segment

MAX_DELAY_STEPS = 32


class PlantConfig(NamedTuple):
    sim_dt: float = 0.001            # 1 kHz physics
    contact_kp: float = 40000.0      # ground stiffness [N/m]
    contact_kd: float = 2000.0       # ground damping [N s/m]
    friction_mu: float = 0.7         # ground friction
    tangential_kp: float = 20000.0   # sticking (anchor spring) stiffness
    tangential_kd: float = 400.0     # tangential damping [N s/m]
    # actuation delay in COMMAND PUSHES (one per control tick)
    delay_steps: int = 0
    joint_damping: float = 0.1       # viscous joint friction


class HybridCommand(NamedTuple):
    """tau = kp (pos_des - q) + kd (vel_des - v) + ff (reference
    HybridJointInterface.h:55-61)."""
    pos_des: torch.Tensor   # (18,)
    vel_des: torch.Tensor   # (18,)
    kp: torch.Tensor        # (18,)
    kd: torch.Tensor        # (18,)
    ff: torch.Tensor        # (18,)


def zero_command(device="cuda", dtype=torch.float32) -> HybridCommand:
    from .. import resolve_device
    z = torch.zeros(NUM_JOINTS, dtype=dtype, device=resolve_device(device))
    return HybridCommand(z, z, z, z, z)


class PlantState(NamedTuple):
    q: torch.Tensor           # (24,)
    v: torch.Tensor           # (24,)
    t: torch.Tensor           # scalar
    cmd_buf: HybridCommand    # (MAX_DELAY_STEPS, 18) each — delay line
    buf_head: torch.Tensor    # int64 write index
    anchors: torch.Tensor     # (4,2) tangential friction anchor points
    ee_wrench: torch.Tensor   # (6,) external world wrench at the arm EE


def init_plant_state(q0, v0=None, model: RobotModel = None, device="cuda",
                     dtype=torch.float32) -> PlantState:
    from .. import resolve_device
    dev = resolve_device(device)
    q0 = torch.as_tensor(q0, dtype=dtype, device=dev)
    v0 = (torch.zeros(NQ, dtype=dtype, device=dev) if v0 is None
          else torch.as_tensor(v0, dtype=dtype, device=dev))
    buf = HybridCommand(*[torch.zeros(MAX_DELAY_STEPS, NUM_JOINTS,
                                      dtype=dtype, device=dev)
                          for _ in range(5)])
    # friction anchors start at the feet
    anchors = (K.contact_positions(model, q0)[:, :2] if model is not None
               else torch.zeros(4, 2, dtype=dtype, device=dev))
    return PlantState(q=q0, v=v0, t=torch.zeros((), dtype=dtype, device=dev),
                      cmd_buf=buf,
                      buf_head=torch.zeros((), dtype=torch.int64, device=dev),
                      anchors=anchors,
                      ee_wrench=torch.zeros(6, dtype=dtype, device=dev))


def delay_steps_for(delay_s: float, push_freq: float = 500.0) -> int:
    """Actuation delay in seconds -> delay-line steps at the push rate."""
    return int(round(delay_s * push_freq))


def hybrid_torque(cmd: HybridCommand, q_joints, v_joints):
    """tau = kp (pos_des - q) + kd (vel_des - v) + ff."""
    return (cmd.kp * (cmd.pos_des - q_joints)
            + cmd.kd * (cmd.vel_des - v_joints) + cmd.ff)


def push_command(state: PlantState, cmd: HybridCommand) -> PlantState:
    """Write a new command into the delay line at the head."""
    head = state.buf_head.reshape(1)
    buf = HybridCommand(*[b.index_copy(0, head, c[None].to(b.dtype))
                          for b, c in zip(state.cmd_buf, cmd)])
    return state._replace(cmd_buf=buf,
                          buf_head=(state.buf_head + 1) % MAX_DELAY_STEPS)


def delayed_command(state: PlantState, delay_steps) -> HybridCommand:
    """The command `delay_steps` pushes old."""
    idx = ((state.buf_head - 1 - delay_steps) % MAX_DELAY_STEPS).reshape(1)
    return HybridCommand(*[b.index_select(0, idx)[0] for b in state.cmd_buf])


def contact_forces(model: RobotModel, cfg: PlantConfig, q, v, anchors):
    """(fc(4,3), damping_diag(12), Jc, new_anchors): compliant normal force
    and anchor-spring Coulomb friction, branch-free. Damping slopes are
    returned for the implicit integration."""
    cache = K.fk(model, q)
    Jc = K.stacked_contact_jacobian(model, q)         # (12,24)
    p = torch.stack([K.frame_pose(model, cache, f)[0]
                     for f in CONTACT_FRAMES])
    vel = (Jc @ v).reshape(4, 3)
    depth = torch.clamp(-p[:, 2], min=0.0)            # penetration
    in_contact = (depth > 0).to(q.dtype)
    fn = torch.clamp(cfg.contact_kp * depth
                     - cfg.contact_kd * vel[:, 2] * in_contact, min=0.0)
    # sticking tangential force toward the anchor
    p_xy = p[:, :2]
    f_t = -cfg.tangential_kp * (p_xy - anchors) \
        - cfg.tangential_kd * vel[:, :2]
    f_mag = torch.linalg.vector_norm(f_t, dim=1) + 1e-9
    scale = torch.clamp(cfg.friction_mu * fn / f_mag, max=1.0)
    f_t = f_t * scale[:, None]
    # slide the anchor so the spring force equals the saturated force
    new_anchors = torch.where(in_contact[:, None] > 0,
                              p_xy + (f_t + cfg.tangential_kd * vel[:, :2])
                              / cfg.tangential_kp, p_xy)
    fc = torch.cat([f_t, fn[:, None]], dim=1) * in_contact[:, None]
    d_diag = torch.stack([cfg.tangential_kd * in_contact,
                          cfg.tangential_kd * in_contact,
                          cfg.contact_kd * in_contact], dim=1)
    return fc, d_diag.reshape(-1), Jc, new_anchors


# the record_function range of one plant substep
STEP_SPAN = "plant.step"


def make_plant_step(model: RobotModel, cfg: PlantConfig):
    """step(state) -> (state', contact_forces(4,3)): one sim_dt of
    semi-implicit Euler with the delayed hybrid-joint actuation; contact
    damping and the command's PD slopes are implicit:
        (M + dt J' D J + dt diag(b)) vdot = tau - h + J' f_c - extra."""
    dt = cfg.sim_dt

    def step(state: PlantState):
        with record_function(STEP_SPAN):
            return _step(state)

    def _step(state: PlantState):
        q, v = state.q, state.v
        cmd = delayed_command(state, cfg.delay_steps)
        tau = torch.cat([q.new_zeros(6), hybrid_torque(cmd, q[6:], v[6:])])
        fc, d_diag, Jc, anchors = contact_forces(model, cfg, q, v,
                                                 state.anchors)
        M = D.mass_matrix(model, q)
        h = D.nonlinear_effects(model, q, v)
        J_ee = K.frame_jacobian(model, q, EE_FRAME)
        rhs = (tau - h + Jc.T @ fc.reshape(-1)
               + J_ee.T @ state.ee_wrench.to(q.dtype))
        zeros6 = q.new_zeros(6)
        b_lhs = torch.cat([zeros6, cfg.joint_damping + cmd.kd
                           + dt * cmd.kp])
        rhs = rhs - torch.cat([zeros6, (cfg.joint_damping + dt * cmd.kp)
                               * v[6:]])
        M_imp = (M + dt * (Jc.T * d_diag[None, :]) @ Jc
                 + dt * torch.diag(b_lhs))
        # solve_ex: no host-side singularity check (keeps the tick async)
        vdot = torch.linalg.solve_ex(M_imp, rhs)[0]
        v_new = v + dt * vdot
        q_new = q + dt * v_new                     # semi-implicit Euler
        return state._replace(q=q_new, v=v_new, t=state.t + dt,
                              anchors=anchors), fc

    return step


def plant_write(step, state: PlantState, cmd: HybridCommand,
                substeps: int) -> PlantState:
    """One write of the hardware seam: push `cmd` into the delay line, then
    `substeps` calls of `step` (make_plant_step's). Under a CUDA-graph
    capture each substep is a segment of its own (utils/graphs.segment),
    replayed in a plant.step range, push_command in the first."""
    state = push_command(state, cmd)
    for i in range(substeps):
        if i:
            segment(STEP_SPAN)
        state, _ = step(state)
    return state

