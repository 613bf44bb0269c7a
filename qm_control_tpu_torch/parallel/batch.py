"""Scenario batching: vmap-lifted MPC and WBC steps (port of
qm_control_tpu/parallel/batch.py).

Every compute function of the port is written for one scenario and lifted
here with torch.func.vmap. A BatchScenario carries per-scenario problem
data (initial state, target trajectory, mode schedule, warm starts) as
tensors with a leading batch axis.

One deliberate difference from the JAX package: there make_batched_wbc
defaults to, and make_batched_cycle rewrites fused_wbc None/True to, the
"xla" cascade (kernels/cascade_exact.py), because on the TPU a vmapped
pallas_call runs its grid steps one after another on one TensorCore
(qm_control_tpu/kernels/hoqp_fused.py:661-666). On the H100 the blocks of
K1's grid run side by side on the 132 SMs, and K1's vmap rule
(kernels/hoqp_fused.py) turns the vmapped WBC into one launch with
grid = B per tick. So the port keeps None/True (cascade="fused") as K1
and leaves "xla" selectable.
"""
from typing import NamedTuple, Optional

import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from ..config import QmConfig, WbcGains
from ..gaits.gait import ModeSchedule
from ..models import centroidal as C
from ..models.spec import RobotModel
from ..mpc.mpc import mpc_step, solve_runner
from ..ocp.problem import make_ocp
from ..ocp.reference import TargetTrajectory
from ..runtime.loop import ControlLoop, LoopConfig
from ..solver.sqp import SqpSettings
from ..wbc.wbc import hierarchical_wbc_update


class BatchScenario(NamedTuple):
    """Per-scenario MPC problem data (leading dim = batch)."""
    t: torch.Tensor             # (B,)
    x: torch.Tensor             # (B, 30)
    target: TargetTrajectory    # (B, K) / (B, K, 37)
    ms: ModeSchedule            # (B, E) / (B, E+1)
    W_warm: torch.Tensor        # (B, N, 30)
    X_warm: torch.Tensor        # (B, N+1, 30)


def stack_scenarios(scenarios) -> BatchScenario:
    """Stack a list of single-scenario tuples into a BatchScenario."""
    return tree_map(lambda *xs: torch.stack(xs), *scenarios)


def make_batched_mpc_step(model: RobotModel, info: C.CentroidalInfo,
                          cfg: QmConfig,
                          settings: Optional[SqpSettings] = None):
    """Returns step(batch: BatchScenario) -> (BatchScenario, MpcPolicy_B).

    One warm-started MPC solve per scenario, vmapped, on the batch's
    device. The returned batch carries the updated warm starts, so calling
    in a loop implements receding-horizon MPC for the whole fleet."""
    settings = settings or SqpSettings(num_iterations=cfg.mpc.num_iterations)
    ocp = make_ocp(model, info, cfg)
    consts = {}

    def one(t, x, target, ms, W_warm, X_warm, shift, cold):
        return mpc_step(ocp, model, info, cfg, settings, t, x, target, ms,
                        W_warm, X_warm, shift, cold)

    # replayed as CUDA graphs on the card (one capture per batch signature)
    vstep = solve_runner(vmap(one, in_dims=(0, 0, 0, 0, 0, 0, None, None)),
                         settings)

    def step(batch: BatchScenario):
        dev = batch.x.device
        if dev not in consts:   # warm shift = one MPC period; cold = False
            consts[dev] = (torch.tensor(1.0 / cfg.mpc.mpc_frequency,
                                        dtype=torch.float32, device=dev),
                           torch.zeros((), dtype=torch.bool, device=dev))
        policy = vstep(*batch, *consts[dev])
        return batch._replace(W_warm=policy.W, X_warm=policy.X), policy

    return step


def make_batched_wbc(model: RobotModel, info: C.CentroidalInfo,
                     gains: WbcGains = None, cascade: str = "fused",
                     device="cuda"):
    """Returns wbc(x_des_B, u_des_B, input_last_B, q_B, v_B, flags_B,
    period, time) -> WbcResult (batched).

    cascade="fused" (default): K1, one launch with grid = B on the card
    (its plain version per scenario on CPU tensors); "xla": the exact-shape
    cascade in plain PyTorch (kernels.cascade_exact, the JAX package's
    default); "hoqp": vmap of the pivoted reference cascade
    (wbc.hoqp.hoqp_solve)."""
    from .. import resolve_device
    fused = {"fused": True, "xla": "xla", "hoqp": False}.get(cascade)
    if fused is None:
        raise ValueError(f"cascade={cascade!r}: 'fused', 'xla' or 'hoqp'")
    gains = gains or WbcGains()
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=resolve_device(device))

    def one(x_des, u_des, input_last, q, v, flags, period, time):
        return hierarchical_wbc_update(model, info, gains, tau_max, x_des,
                                       u_des, input_last, q, v, flags,
                                       period, time, fused_cascade=fused)

    return vmap(one, in_dims=(0, 0, 0, 0, 0, 0, None, None))


def make_batched_cycle(model: RobotModel, info: C.CentroidalInfo,
                       cfg: QmConfig, loop_cfg=None,
                       gains: WbcGains = None, device="cuda"):
    """The full closed-loop cycle (1 MPC solve + control ticks x WBC +
    plant substeps; runtime.loop.make_cycle) vmapped over scenarios.
    Returns (vcycle, make_carries):

        vcycle(carries_B, target_B, ms_B, gains) -> (carries_B, metrics_B)
        make_carries(q0, B) -> batched CycleCarry

    The WBC follows loop_cfg.fused_wbc (default None: K1, so every tick of
    the batch is one K1 launch with grid = B on the card)."""
    loop = ControlLoop(model, info, cfg, loop_cfg or LoopConfig(),
                       gains=gains, device=device)
    vcycle = vmap(loop._cycle, in_dims=(0, 0, 0, None))

    def make_carries(q0, B):
        return tree_map(lambda a: a[None].expand(B, *a.shape).clone(),
                        loop.init_carry(q0))

    return vcycle, make_carries
