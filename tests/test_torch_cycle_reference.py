"""The port's batched closed-loop cycle against the benchmark's plain
reference of one control period (qmbench/reference/cycle.py, float64).

parallel.make_batched_cycle runs B = 3 trot scenarios from the seed's
spawn heights for two periods at the cut horizon of the benchmark's CPU
tests (0.12 s of 0.04 s nodes), 1 kHz ticks, one plant step each, the
one-period MRT lag. Each scenario's second period is recomputed by the
reference from the port's carry at the period's start and compared on
every number of the benchmark's check. The first period is the landing
from the spawn, where last-bit differences between float32 and float64
grow about twice a tick (its plant reads 5e-3 apart after 10 ticks);
the benchmark's warm-up periods pass it by in the same way. Three faults
planted in the port's period each fail at least one tolerance: the ticks
executing the fresh policy (mrt_policy_lag = 0), a second plant step per
tick, and the WBC's torques offset by 2 Nm.
"""
import importlib
import json
import os

import pytest
import torch

from qmbench import cycle_check
from qm_control_tpu_torch.runtime import loop as L

FC = importlib.import_module("qmbench.drivers.fleet_cycle")
CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "qmbench", "configs",
    "fleet_cycle_trot.json")
SEED = 2 ** 31 + 7
B, CYCLES = 3, 2
TRAFFIC = {"batch": B, "span_s": 10.0, "rebuild_s": 5.0}

# Each tolerance sits between what the port reads here (float32 against
# float64) and what the faults read, with a reason for its size:
TOL = {
    # one SQP iteration of the same problem in float32, just after the
    # landing: rounding amplified by the plan's conditioning (up to 1.4e-4
    # here; the faults act on the ticks and read as the port does)
    "cost_rel": 1e-3,
    # the fresh plan's states: float32 rounding of the Riccati sweep
    # (~3e-7 here)
    "X_gap": 1e-5,
    # the WBC's torques: the port's cascade runs a fixed number of
    # interior-point iterations in float32, the reference's solves each
    # level to convergence in float64 (~9e-3 Nm here; a 2 Nm fault moves
    # the last tick ~0.9 Nm once the WBC has pushed back)
    "tau_gap": 0.1,
    # the plant after 10 ticks: float32 torques and integration (~5e-5
    # here; the faults move it 7e-4 and more)
    "q_gap": 2e-4,
    # (~3e-3 rad/s here; the faults move it 0.08 and more)
    "v_gap": 0.02,
}


def _config():
    with open(CONFIG) as fh:
        cfg = json.load(fh)
    cfg["mpc"].update(time_horizon=0.12, dt=0.04)
    return cfg


def _fault(mp, kind):
    """Plant `kind` in the port's period."""
    if kind == "lag0":
        real = FC.loop_config

        def lag0(*a):
            return real(*a)._replace(mrt_policy_lag=0)
        mp.setattr(FC, "loop_config", lag0)
    elif kind == "substep":
        mp.setattr(L.LoopConfig, "substeps_per_tick",
                   property(lambda self: 2))
    elif kind == "offset":
        real = L.hierarchical_wbc_update

        def offset(*a, **k):
            r = real(*a, **k)
            return r._replace(torques=r.torques + torch.tensor(
                [2.0] + [0.0] * 17))
        mp.setattr(L, "hierarchical_wbc_update", offset)


def _gaps(kind):
    """[gaps of each scenario-period] of the port with `kind` planted."""
    cfg = _config()
    wl = {"traffic": TRAFFIC, "check": {"sample": B, "cycles": 1}}
    with pytest.MonkeyPatch.context() as mp:
        _fault(mp, kind)
        drv = FC.Driver(cfg, wl, SEED, torch.device("cpu"))
        carry, recs = drv.carries, []
        for _ in range(CYCLES):
            after, m = drv.vcycle(carry, drv.target, drv.ms, drv.gains)
            recs.append((carry, m, after))
            carry = after
    jobs = [(cfg, TRAFFIC, 0, FC._cpu(FC._state(a, i)),
             FC._cpu(FC._outputs(m, b, i)))
            for a, m, b in recs[1:] for i in range(B)]
    return [cycle_check.gaps(j) for j in jobs]


@pytest.fixture(scope="module")
def readings():
    torch.set_num_threads(1)
    return {kind: _gaps(kind) for kind in ("port", "lag0", "substep",
                                           "offset")}


@pytest.mark.parametrize("number", list(TOL))
def test_port_period_matches_the_reference(readings, number):
    got = [g[number] for g in readings["port"]]
    assert len(got) == B * (CYCLES - 1)
    assert max(got) < TOL[number], got


@pytest.mark.parametrize("kind", ["lag0", "substep", "offset"])
def test_planted_fault_fails_a_tolerance(readings, kind):
    worst = cycle_check.largest(readings[kind])
    assert any(not worst[k] < TOL[k] for k in TOL), worst
