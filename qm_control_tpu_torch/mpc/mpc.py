"""MPC solve and policy evaluation (port of qm_control_tpu/mpc/mpc.py;
OCS2 SqpMpc::run + MPC_MRT_Interface::evaluatePolicy, reference
QMController.cpp:286-334, :128-146).

`mpc_step` is one solve as a plain function of tensors on one device (no
host read inside). Warm starting follows OCS2's non-cold-start behaviour:
the previous (X, W) are shifted onto the new horizon by interpolation at
the fractional node positions, the tail repeating the last value
(coldStart false, task.info:135).

`solve_runner` replays a solve as CUDA graphs on the card: its callers
outside any transform (`MpcSolver.solve`, and parallel/batch.py's batched
step) pay the host's dispatch of ~37k eager ops once per input signature
instead of once per call (solves without LU solves).
"""
from typing import NamedTuple, Optional

import torch
from torch.func import vmap
from torch.profiler import record_function

from ..config import QmConfig
from ..gaits.gait import ModeSchedule, mode_at_time
from ..models import centroidal as C
from ..models.spec import RobotModel
from ..ocp.problem import make_node_data, make_ocp
from ..ocp.reference import TargetTrajectory
from ..solver.sqp import SqpSettings, sqp_solve
from ..utils.graphs import GraphRunner


class MpcPolicy(NamedTuple):
    """Time-indexed optimized policy (the MRT policy buffer content)."""
    t_nodes: torch.Tensor   # (N+1,)
    X: torch.Tensor         # (N+1, 30) optimized states
    U: torch.Tensor         # (N+1, 30) physical inputs (last repeated)
    modes: torch.Tensor     # (N+1,) int32 planned modes at the nodes
    cost: torch.Tensor      # scalar solver cost
    W: torch.Tensor         # (N, nw) reduced inputs (warm-start state)
    alpha: torch.Tensor     # accepted line-search step of the last iteration
    defect: torch.Tensor    # max |defect| at the returned iterate


# the record_function range of one policy evaluation
EVALUATE_SPAN = "mpc.evaluate"


def evaluate_policy(policy: MpcPolicy, t):
    """(x_des(30), u_des(30), mode) at time t — linear interpolation
    between nodes, mode piecewise-constant (OCS2 MRT semantics). t is a
    0-dim tensor on the policy's device; nothing is read back to the host."""
    with record_function(EVALUATE_SPAN):
        tn = policy.t_nodes
        t = torch.as_tensor(t, dtype=tn.dtype, device=tn.device)
        idx = torch.searchsorted(tn, t.reshape(1), right=True) - 1
        idx = torch.clamp(idx, 0, tn.shape[0] - 2)     # (1,) on the device
        # index_select, not tn[idx]: a 0-dim index would be read to the host
        t0, t1 = tn.index_select(0, idx)[0], tn.index_select(0, idx + 1)[0]
        a = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
        x = (1 - a) * policy.X.index_select(0, idx)[0] \
            + a * policy.X.index_select(0, idx + 1)[0]
        u = (1 - a) * policy.U.index_select(0, idx)[0] \
            + a * policy.U.index_select(0, idx + 1)[0]
        return x, u, policy.modes.index_select(0, idx)[0]


def shift_warm_start(W, shift, dt):
    """Shift a previous trajectory by `shift` seconds onto the new horizon
    by linear interpolation at the fractional node positions (with a 10 ms
    MPC period under 15 ms nodes an integer shift would always round to
    zero); beyond the old horizon the last value repeats."""
    N = W.shape[0]
    pos = torch.arange(N, dtype=W.dtype, device=W.device) + shift / dt
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, N - 1)
    i1 = torch.clamp(i0 + 1, 0, N - 1)
    a = torch.clamp(pos - i0.to(W.dtype), 0.0, 1.0)[:, None]
    return (1.0 - a) * W.index_select(0, i0) + a * W.index_select(0, i1)


# the record_function range of one solve; solver/sqp.py's sqp.* ranges
# nest inside it
SOLVE_SPAN = "mpc.solve"


def mpc_step(ocp, model: RobotModel, info: C.CentroidalInfo, cfg: QmConfig,
             settings: SqpSettings, t, x, target: TargetTrajectory,
             ms: ModeSchedule, W_warm, X_warm, warm_shift,
             cold, ee_wrench=None) -> MpcPolicy:
    """One MPC solve. t, warm_shift: 0-dim tensors; cold: a bool tensor
    (or bool) choosing the QMInitializer start over the shifted warm
    start. ee_wrench: an optional measured world wrench [f(3); tau(3)] at
    the arm EE, fed through to the OCP dynamics (disturbance-aware
    planning, beyond the reference, whose MPC never sees the wrench;
    None = off)."""
    with record_function(SOLVE_SPAN):
        params = make_node_data(ms, target, x, t, cfg)
        node_data = (params.t_nodes[:-1], params.contact_flags[:-1],
                     params.swing_zdot[:-1])
        final_data = params.t_nodes[-1]

        def dyn(kd, xx, ww):
            return ocp.dynamics(kd[0], kd[1], kd[2], xx, ww,
                                ee_wrench=ee_wrench)

        def sc(kd, xx, ww):
            return ocp.stage_cost(kd[0], kd[1], kd[2], xx, ww, target)

        def fc(fd, xx):
            return ocp.final_cost(fd, xx, target)

        def sq(kd, xx, ww):
            return ocp.stage_quadratize(kd[0], kd[1], kd[2], xx, ww, target)

        def fq(fd, xx):
            return ocp.final_quadratize(fd, xx, target)

        def cd(kd, xx, ww):
            return ocp.cost_and_dynamics(kd[0], kd[1], kd[2], xx, ww, target,
                                         ee_wrench=ee_wrench)

        def sl(kd, xx, ww):
            return ocp.stage_linearize(kd[0], kd[1], kd[2], xx, ww, target,
                                       ee_wrench=ee_wrench)

        # QMInitializer (reference QMInitializer.cpp:18-41): weight-
        # compensating contact forces per node, the current state tiled
        # over the horizon
        W_init = vmap(lambda f: C.weight_compensating_input(info, f))(
            params.contact_flags[:-1]).to(W_warm.dtype)
        X_init = params.x0[None].expand(cfg.mpc.num_nodes + 1, -1)
        W0 = torch.where(torch.as_tensor(cold, device=W_warm.device), W_init,
                         shift_warm_start(W_warm, warm_shift, cfg.mpc.dt))
        X0 = torch.where(torch.as_tensor(cold, device=W_warm.device), X_init,
                         shift_warm_start(X_warm, warm_shift, cfg.mpc.dt))
        sol = sqp_solve(dyn, sc, fc, node_data, final_data, params.x0, X0, W0,
                        settings, stage_quad=sq, final_quad=fq,
                        cost_and_dynamics=cd, stage_linearize=sl)

        U = vmap(ocp.input_of)(params.t_nodes[:-1], params.contact_flags[:-1],
                               params.swing_zdot[:-1], sol.X[:-1], sol.W)
        U = torch.cat([U, U[-1:]], dim=0)
        modes = mode_at_time(ms, params.t_nodes).to(torch.int32)
        return MpcPolicy(t_nodes=params.t_nodes, X=sol.X, U=U, modes=modes,
                         cost=sol.cost, W=sol.W, alpha=sol.alpha,
                         defect=sol.defect)


def solve_runner(fn, settings: SqpSettings):
    """What runs fn, a solve with `settings`: the graph runner "mpc"
    (utils/graphs.py), or fn itself (eagerly) where the solve takes LU
    solves (the parallel Riccati of solver/pariccati.py, or `unrolled_ops`
    off): batched torch.linalg.solve_ex of 30 x 30 systems fails under a
    CUDA-graph capture on the card from a batch of 17 (an H100, torch
    2.11)."""
    lu = settings.parallel_riccati or not settings.unrolled_ops
    return fn if lu else GraphRunner(fn, "mpc", span=SOLVE_SPAN)


class MpcSolver:
    """Host-side owner of the OCP closures; warm-starts itself.

        mpc = MpcSolver(model, info, cfg, device="cuda")
        policy = mpc.solve(t, x, target, mode_schedule)
    """

    def __init__(self, model: RobotModel, info: C.CentroidalInfo,
                 cfg: QmConfig, settings: Optional[SqpSettings] = None,
                 device="cuda"):
        from .. import resolve_device
        self.device = resolve_device(device)
        self.model = model
        self.info = info
        self.cfg = cfg
        self.settings = settings or SqpSettings(
            num_iterations=cfg.mpc.num_iterations)
        self.N = cfg.mpc.num_nodes
        self._ocp = make_ocp(model, info, cfg)
        self._step = solve_runner(mpc_step, self.settings)
        self.reset()

    def reset(self):
        self._W_prev = None
        self._X_prev = None
        self._t_prev = None

    def solve(self, t, x, target: TargetTrajectory,
              ms: ModeSchedule) -> MpcPolicy:
        dev, f32 = self.device, torch.float32
        cold = self._W_prev is None or self.cfg.mpc.cold_start
        if cold:
            W_warm = torch.zeros(self.N, 30, dtype=f32, device=dev)
            X_warm = torch.zeros(self.N + 1, 30, dtype=f32, device=dev)
            shift = 0.0
        else:
            W_warm, X_warm = self._W_prev, self._X_prev
            shift = float(t) - float(self._t_prev)
        policy = self._step(
            self._ocp, self.model, self.info, self.cfg, self.settings,
            torch.as_tensor(t, dtype=f32, device=dev),
            torch.as_tensor(x, dtype=f32, device=dev), target, ms,
            W_warm, X_warm, torch.tensor(shift, dtype=f32, device=dev),
            torch.tensor(cold, device=dev))
        self._W_prev, self._X_prev, self._t_prev = policy.W, policy.X, t
        return policy
