"""Physics plant (port of qm_control_tpu/runtime/plant.py): full rigid-body
dynamics, compliant ground contact with anchor-spring (sticking) friction,
and hybrid-joint actuation through a command delay line (reference
qm_gazebo/src/QMHWSim.cpp:98-116).

State is a NamedTuple of tensors; every update returns a new state (no
in-place writes), and nothing is read back to the host, so a tick stays
asynchronous on the card.

`GraphedPlantWrite` runs one write of the hardware seam (`plant_write`:
push_command, then the substeps) and on the card replays it as CUDA
graphs, so the host dispatches the write's ~2.9k eager ops once per input
signature instead of once per write.
"""
import threading
from typing import NamedTuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..models import dynamics as D
from ..models import kinematics as K
from ..models.spec import CONTACT_FRAMES, EE_FRAME, NQ, NUM_JOINTS, RobotModel

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
                substeps: int, cut=None) -> PlantState:
    """One write of the hardware seam: push `cmd` into the delay line, then
    `substeps` calls of `step` (make_plant_step's). `cut()`, where given,
    runs between two substeps."""
    state = push_command(state, cmd)
    for i in range(substeps):
        if i and cut is not None:
            cut()
        state, _ = step(state)
    return state


# How often GraphedPlantWrite engages, since import: writes run eagerly
# (CPU tensors, or a key's first write), captures, and replays (the
# capturing write replays too). Its hit share is graph_replays / all writes.
eager_writes = 0
graph_captures = 0
graph_replays = 0
_COUNT_LOCK = threading.Lock()      # writes may come from several threads

# the host op under which each substep's segment replays, inside its
# plant.step range, so that a trace links the segment's kernels to it
REPLAY_OP = "plant.graph_replay"


class _WriteGraphs:
    """One capture of plant_write on static inputs: a CUDA graph per
    substep (push_command in the first), in one memory pool, replayed in
    order."""

    def __init__(self, step, leaves, spec, substeps):
        global graph_captures
        dev = leaves[0].device
        self.inputs = [a.clone() for a in leaves]
        self.graphs = []
        self.stream = torch.cuda.current_stream(dev)
        self._pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(self.stream)
        with torch.cuda.stream(side):
            self._begin()
            try:
                out = plant_write(step, *tree_unflatten(self.inputs, spec),
                                  substeps, cut=self._cut)
            finally:        # never leave the thread capturing
                self.graphs[-1].capture_end()
        self.stream.wait_stream(side)
        self.out, self.out_spec = tree_flatten(out)
        with _COUNT_LOCK:
            graph_captures += 1

    def _begin(self):
        g = torch.cuda.CUDAGraph()
        self.graphs.append(g)
        g.capture_begin(pool=self._pool, capture_error_mode="thread_local")

    def _cut(self):
        self.graphs[-1].capture_end()
        self._begin()

    def __call__(self, leaves):
        global graph_replays
        stream = torch.cuda.current_stream(self.inputs[0].device)
        if stream != self.stream:   # the last replay may still read inputs
            stream.wait_stream(self.stream)
            self.stream = stream
        for s, a in zip(self.inputs, leaves):
            s.copy_(a)
        for g in self.graphs:
            with record_function(STEP_SPAN), _RecordFunctionFast(REPLAY_OP):
                g.replay()
        with _COUNT_LOCK:
            graph_replays += 1
        return tree_unflatten([a.clone() for a in self.out], self.out_spec)


class GraphedPlantWrite:
    """plant_write(step, state, cmd, substeps), replayed as CUDA graphs on
    the card (the protocol of mpc.mpc.GraphedSolve).

    A write's key is `substeps` and the shape, dtype and device of each
    tensor of (state, cmd). On CPU tensors the write runs eagerly. On the
    card a key's first write runs eagerly (it fills the models' constant
    caches, the cuBLAS and cuSOLVER handles and the allocator); its
    second captures the write on a side stream, one CUDA graph per
    substep, and replays them; every later write copies (state, cmd) into
    the capture's inputs and replays on the caller's current stream. Each
    segment replays inside its own plant.step range, so a trace keeps one
    per substep. A write returns fresh tensors (clones of the capture's
    outputs): a replay never writes into a state a caller holds."""

    def __init__(self, step):
        self.step = step
        self._graphs = {}
        self._seen = set()

    def __call__(self, state: PlantState, cmd: HybridCommand,
                 substeps: int) -> PlantState:
        global eager_writes
        leaves, spec = tree_flatten((state, cmd))
        graphs = None
        if all(a.is_cuda for a in leaves):
            key = (substeps, spec, tuple((tuple(a.shape), a.dtype, a.device)
                                         for a in leaves))
            graphs = self._graphs.get(key)
            if graphs is None and key in self._seen:
                graphs = self._graphs[key] = _WriteGraphs(
                    self.step, leaves, spec, substeps)
            elif graphs is None:
                self._seen.add(key)
        if graphs is None:
            with _COUNT_LOCK:
                eager_writes += 1
            return plant_write(self.step, state, cmd, substeps)
        return graphs(leaves)
