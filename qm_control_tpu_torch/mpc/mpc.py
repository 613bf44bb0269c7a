"""MPC policy buffer and MRT policy evaluation (port of the policy half of
qm_control_tpu/mpc/mpc.py, reference MPC_MRT_Interface::evaluatePolicy).

The solver half (`mpc_step`, `shift_warm_start`, `MpcSolver`) comes with
the MPC slice.
"""
from typing import NamedTuple

import torch


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


def evaluate_policy(policy: MpcPolicy, t):
    """(x_des(30), u_des(30), mode) at time t — linear interpolation
    between nodes, mode piecewise-constant (OCS2 MRT semantics). t is a
    0-dim tensor on the policy's device; nothing is read back to the host."""
    tn = policy.t_nodes
    t = torch.as_tensor(t, dtype=tn.dtype, device=tn.device)
    idx = torch.searchsorted(tn, t.reshape(1), right=True) - 1
    idx = torch.clamp(idx, 0, tn.shape[0] - 2)         # (1,) on the device
    # index_select, not tn[idx]: a 0-dim index would be read to the host
    t0, t1 = tn.index_select(0, idx)[0], tn.index_select(0, idx + 1)[0]
    a = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    x = (1 - a) * policy.X.index_select(0, idx)[0] \
        + a * policy.X.index_select(0, idx + 1)[0]
    u = (1 - a) * policy.U.index_select(0, idx)[0] \
        + a * policy.U.index_select(0, idx + 1)[0]
    return x, u, policy.modes.index_select(0, idx)[0]
