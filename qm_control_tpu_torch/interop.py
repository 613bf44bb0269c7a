"""numpy -> torch converters for state carried over from the JAX package.

Pure numpy in, tensors out: this module never imports the JAX package.
A caller that holds JAX state converts its leaves with np.asarray and
hands them here, so both packages can start from the identical state.
"""
import numpy as np
import torch

from . import resolve_device
from .gaits.gait import ModeSchedule
from .kernels.cascade_exact import ExactWarm
from .kernels.hoqp_fused import WARM_ROWS, warm_width
from .mpc.mpc import MpcPolicy
from .ocp.reference import TargetTrajectory
from .parallel.batch import BatchScenario
from .runtime.estimator import ImuEstimatorState
from .runtime.loop import CycleCarry
from .runtime.plant import HybridCommand, PlantState

JAX_LANES = 128     # the JAX kernel's padded warm width


def warm_from_jax(warm, nv: int = 56, device="cuda") -> torch.Tensor:
    """JAX K1 warm buffer (9, 128) -> the port's exact (9, max(nv, 36)).
    Rows keep the JAX order; lanes past each row's length are inert in
    both packages, so the leading W lanes carry all of the state."""
    w = np.asarray(warm, dtype=np.float32)
    if w.shape != (WARM_ROWS, JAX_LANES):
        raise ValueError(f"JAX warm buffer shape {w.shape} != (9, 128)")
    return torch.as_tensor(w[:, :warm_width(nv)].copy(),
                           device=resolve_device(device))


def warm_to_jax(warm) -> np.ndarray:
    """Port warm buffer (9, W) -> JAX layout (9, 128): zero-padded lanes,
    row 0 (validity) broadcast across all lanes as the JAX kernel writes it."""
    w = warm.detach().cpu().numpy() if isinstance(warm, torch.Tensor) \
        else np.asarray(warm, dtype=np.float32)
    out = np.zeros((WARM_ROWS, JAX_LANES), dtype=np.float32)
    out[:, :w.shape[1]] = w
    out[0] = w[0].max()
    return out


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype, device=dev)


def plant_state_from_numpy(q, v, t, cmd_buf, buf_head, anchors, ee_wrench,
                           device="cuda") -> PlantState:
    """PlantState from numpy leaves; cmd_buf is the 5 (32, 18) delay-line
    arrays in HybridCommand order (pos_des, vel_des, kp, kd, ff)."""
    dev = resolve_device(device)
    return PlantState(q=_t(q, dev), v=_t(v, dev), t=_t(t, dev),
                      cmd_buf=HybridCommand(*[_t(b, dev) for b in cmd_buf]),
                      buf_head=_t(buf_head, dev, torch.int64),
                      anchors=_t(anchors, dev), ee_wrench=_t(ee_wrench, dev))


def cycle_carry_from_numpy(leaves: dict, device="cuda") -> CycleCarry:
    """CycleCarry from a dict of the JAX CycleCarry's leaves as numpy:
    'plant' (a dict with the PlantState fields, 'cmd_buf' a sequence of 5
    arrays), 'W_warm', 'X_warm', 'input_last', 'last_yaw', 't', 'safe',
    and 'policy' (a dict with the MpcPolicy fields, stacked over the lag
    depth) or None."""
    dev = resolve_device(device)
    policy = leaves.get("policy")
    if policy is not None:
        policy = policy_from_numpy(policy, device=dev)
    return CycleCarry(
        plant=plant_state_from_numpy(**leaves["plant"], device=dev),
        W_warm=_t(leaves["W_warm"], dev), X_warm=_t(leaves["X_warm"], dev),
        input_last=_t(leaves["input_last"], dev),
        last_yaw=_t(leaves["last_yaw"], dev), t=_t(leaves["t"], dev),
        safe=_t(leaves["safe"], dev, torch.bool), policy=policy)


def target_from_numpy(times, states, device="cuda") -> TargetTrajectory:
    """TargetTrajectory from the numpy leaves of an already padded JAX
    target (times (K,), states (K, 37)), kept as they are."""
    dev = resolve_device(device)
    return TargetTrajectory(_t(times, dev), _t(states, dev))


def mode_schedule_from_numpy(event_times, modes, device="cuda") -> ModeSchedule:
    """ModeSchedule from the numpy leaves of a padded JAX mode schedule."""
    dev = resolve_device(device)
    return ModeSchedule(_t(event_times, dev), _t(modes, dev, torch.int32))


def policy_from_numpy(policy: dict, device="cuda") -> MpcPolicy:
    """MpcPolicy from a dict of the JAX MpcPolicy's leaves as numpy (any
    leading stack axes kept)."""
    dev = resolve_device(device)
    return MpcPolicy(**{k: _t(policy[k], dev, torch.int32 if k == "modes"
                              else torch.float32)
                        for k in MpcPolicy._fields})


def exact_warm_from_numpy(leaves, device="cuda") -> ExactWarm:
    """ExactWarm from the nine numpy leaves of a JAX ExactWarm, in field
    order (valid, z0, v0, lam_a, lam_b, z1, lam1, z2, lam2); any leading
    batch axes kept."""
    dev = resolve_device(device)
    return ExactWarm(*[_t(a, dev) for a in leaves])


def exact_warm_to_numpy(warm: ExactWarm) -> list:
    """The nine leaves of an ExactWarm as numpy, in field order."""
    return [a.detach().cpu().numpy() for a in warm]


def batch_scenario_from_numpy(t, x, target_times, target_states,
                              event_times, modes, W_warm, X_warm,
                              device="cuda") -> BatchScenario:
    """BatchScenario from the numpy leaves of a JAX BatchScenario (each
    with its leading batch axis)."""
    dev = resolve_device(device)
    return BatchScenario(
        t=_t(t, dev), x=_t(x, dev),
        target=TargetTrajectory(_t(target_times, dev), _t(target_states, dev)),
        ms=ModeSchedule(_t(event_times, dev), _t(modes, dev, torch.int32)),
        W_warm=_t(W_warm, dev), X_warm=_t(X_warm, dev))


def imu_estimator_state_from_numpy(zyx_offset, initialized,
                                   device="cuda") -> ImuEstimatorState:
    """ImuEstimatorState from the numpy leaves of a JAX ImuEstimatorState
    (the latched (3,) ZYX offset and the 0/1 scalar)."""
    dev = resolve_device(device)
    return ImuEstimatorState(_t(zyx_offset, dev), _t(initialized, dev))
