"""Failure detection (port of qm_control_tpu/runtime/safety.py; reference
SafetyChecker.h:16-35): base roll inside (-pi/2, pi/2), finite state,
base height inside limits, finite policy cost. Branch-free, returns a
bool tensor (no host read)."""
import math

import torch


def safety_check(x, policy_cost=None, height_limits=(0.08, 1.0)):
    """True = safe. x: centroidal state (30,)."""
    roll = x[11]                          # base pose [p(3), z, y, x]
    ok = (roll > -math.pi / 2) & (roll < math.pi / 2)
    ok = ok & torch.isfinite(x).all()
    ok = ok & (x[8] > height_limits[0]) & (x[8] < height_limits[1])
    if policy_cost is not None:
        ok = ok & torch.isfinite(torch.as_tensor(policy_cost))
    return ok
