"""PyTorch port vs JAX reference: the experiments.

experiments.batched_rollouts (config #5, the domain-randomized fleet of
batched MPC solves) at tests/test_experiments.py's _ci_cfg, B = 4, 2
steps, the same seed: the same keys, finite_fraction 1.0, cost_mean
within 1e-3 relative (the tolerance of one MPC solve in
tests/test_torch_mpc.py; measured 5e-6).

The host protocol of traverse_ee_hold, ee_tracking and
disturbance_rejection (phases, command ramps, targets re-issued per
chunk, receding mode schedules, error windows, the disturbance's onset
and release, the settling search), held against the JAX functions on
every branch. Both packages run against the same scripted stand-in for
ControlLoop, whose numpy core moves the base with the commanded velocity
of the target it is handed and answers each cycle with scripted EE
errors, so the comparison sees the host protocol alone: every target and
mode schedule it hands the loop (knot times and modes exact, states
within 1e-6 of max(1, |s|)) and every value returned (within 1e-5 of
max(1, |v|), and 2e-4 mm more for EE errors: the plan/execution split
differences each package's f32 FK of a metre-scale position, whose last
bit is 6e-5 mm). The real closed loop is compared in
tests/test_torch_experiments_loop.py and test_torch_traverse_loop.py.
"""
import dataclasses
from types import SimpleNamespace
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu import experiments as JE
from test_experiments import _ci_cfg

from qm_control_tpu_torch import config as TCfg
from qm_control_tpu_torch import experiments as TE

torch.set_num_threads(1)


def _tci_cfg():
    """tests/test_experiments.py's _ci_cfg in the port."""
    tcfg = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=0.5, dt=0.025, num_iterations=1))
    return tcfg.with_(wbc=dataclasses.replace(tcfg.wbc,
                                              arm_settling_time=0.0))


def test_batched_rollouts_match_jax():
    jr = JE.batched_rollouts(cfg=_ci_cfg(), batch=4, num_steps=2)
    tr = TE.batched_rollouts(cfg=_tci_cfg(), batch=4, num_steps=2,
                             device="cpu")
    assert tr.keys() == jr.keys()
    assert tr["experiment"] == jr["experiment"]
    assert tr["finite_fraction"] == jr["finite_fraction"] == 1.0
    assert abs(tr["cost_mean"] - jr["cost_mean"]) <= 1e-3 * abs(
        jr["cost_mean"])


# ------------------------------------ the experiments' host protocol ---

class _Plant(NamedTuple):
    q: object
    v: object
    ee_wrench: object


class _Carry(NamedTuple):
    plant: _Plant
    t: object
    last_yaw: object
    safe: object


class _Metrics(NamedTuple):
    ee_pos_err: object
    ee_ori_err: object
    safe: object
    ee_pos: object
    ee_ref: object
    x_des: object


def _scripted_loop(pkg, record, unsafe_after=None):
    """A ControlLoop stand-in for package `pkg` ("jax" or "torch") that
    appends what it is handed to `record`."""
    if pkg == "jax":
        def wrap(a, dtype=np.float32):
            return jnp.asarray(np.asarray(a, dtype))
        unwrap = np.asarray
    else:
        def wrap(a, dtype=np.float32):
            return torch.as_tensor(np.asarray(a, dtype))

        def unwrap(a):
            return a.detach().cpu().numpy() if torch.is_tensor(a) \
                else np.asarray(a)

    class Loop:
        def __init__(self, model, info, cfg, loop_cfg, gains=None,
                     device="cpu"):
            record.append(("loop", loop_cfg.control_freq,
                           loop_cfg.mpc_freq, loop_cfg.mpc_wrench_feedthrough,
                           loop_cfg.mrt_policy_lag,
                           loop_cfg.delay_compensation_s,
                           loop_cfg.plant.delay_steps))
            self.device = torch.device("cpu")
            self.period = np.float32(1.0 / loop_cfg.mpc_freq)
            self.cycle_timer = SimpleNamespace(summary=lambda: "")
            self.err = 0.0

        def init_carry(self, q0):
            q = np.asarray(q0, np.float32)
            return _Carry(_Plant(wrap(q), wrap(np.zeros(24)),
                                 wrap(np.zeros(6))), wrap(0.0), wrap(q[3]),
                          wrap(True, bool))

        def warmup(self, carry, target, ms, num_solves=20):
            record.append(("warmup", num_solves, unwrap(target.times),
                           unwrap(target.states), unwrap(ms.event_times),
                           unwrap(ms.modes)))
            return carry

        def run(self, carry, target, ms, num_cycles, log=None):
            times, states = unwrap(target.times), unwrap(target.states)
            record.append(("run", float(unwrap(carry.t)), num_cycles, times,
                           states, unwrap(ms.event_times), unwrap(ms.modes)))
            q = unwrap(carry.plant.q).astype(np.float64)
            v = unwrap(carry.plant.v).astype(np.float64)
            load = abs(float(unwrap(carry.plant.ee_wrench)[1])) / 25.0
            t = np.float32(unwrap(carry.t))
            rows = []
            for _ in range(num_cycles):
                t = np.float32(t + self.period)
                q[0] += float(self.period) * states[0, 0]   # commanded vx
                q[1] += float(self.period) * (v[1] - 0.05 * load)
                v[1] *= 0.5
                self.err = (0.6 * self.err + 0.02 * load
                            + 0.002 * (1.0 + np.sin(13.0 * t)))
                ref = states[0, 30:33]
                rows.append(dict(
                    ee_pos_err=self.err,
                    ee_ori_err=0.001 * (1.0 + np.cos(7.0 * t)),
                    safe=unsafe_after is None or t < unsafe_after,
                    ee_pos=ref + np.array([0.0, -self.err, 0.0]),
                    ee_ref=ref, x_des=np.concatenate([np.zeros(6), q])))
                if log is not None:
                    log.append(float(t), **rows[-1])
            m = _Metrics(*[wrap(np.stack([r[k] for r in rows]),
                                bool if k == "safe" else np.float32)
                           for k in _Metrics._fields])
            plant = carry.plant._replace(q=wrap(q), v=wrap(v))
            safe = bool(unwrap(carry.safe)) and bool(unwrap(m.safe).all())
            return carry._replace(plant=plant, t=wrap(t),
                                  safe=wrap(safe, bool)), m

    return Loop


def _records_match(jrec, trec):
    assert len(trec) == len(jrec)
    for j, t in zip(jrec, trec):
        assert t[0] == j[0]
        if j[0] == "loop":
            assert t == j
            continue
        assert t[1] == j[1]
        if j[0] == "run":
            assert t[2] == j[2]
        np.testing.assert_array_equal(t[-4], j[-4])        # knot times
        gap = np.abs(t[-3].astype(np.float64) - j[-3])
        assert (gap <= 1e-6 * np.maximum(1.0, np.abs(j[-3]))).all()
        np.testing.assert_array_equal(t[-2], j[-2])        # mode events
        np.testing.assert_array_equal(t[-1], j[-1])


def _results_match(jr, tr):
    jr = {k: v for k, v in jr.items() if k not in ("log", "cycle_timer")}
    tr = {k: v for k, v in tr.items() if k not in ("log", "cycle_timer")}
    assert tr.keys() == jr.keys()
    for k, a in jr.items():
        b = tr[k]
        if isinstance(a, (bool, np.bool_, str)) or a is None:
            assert b == a, (k, a, b)
        else:
            ulps = 2e-4 if k.endswith("_mm") else 0.0
            assert abs(b - a) <= 1e-5 * max(1.0, abs(a)) + ulps, (k, a, b)


PROTOCOL_CASES = [
    # settle, walk with ramp and taper, the goal reached with a gait switch
    # to stance, the walk and after windows
    ("traverse_ee_hold", dict(speed=-0.05, distance=0.004, max_time=2.0,
                              warmup=2, taper_dist=0.05, stop_gait="stance",
                              delay_s=0.009), None),
    # a step command (no ramp), the goal never reached, a fall ends the run
    ("traverse_ee_hold", dict(speed=-0.1, max_time=2.0, warmup=3,
                              cmd_ramp_s=0.0, control_freq=500.0), 0.9),
    # the 8-knot preview with a lead, the window after 1.0 s
    ("ee_tracking", dict(duration=1.6, warmup=2, target_lead_s=0.05,
                         mrt_policy_lag=2), None),
    # the instantaneous target, re-issued each chunk
    ("ee_tracking", dict(duration=1.3, warmup=2, preview=False,
                         amplitude=0.05, period=2.0), None),
    # onset with a base push, release, settled inside the band
    ("disturbance_rejection", dict(ee_force=25.0, push_velocity=0.1,
                                   settle=0.1, hold=0.2, release=0.3,
                                   warmup=2, settle_band_mm=25.0), None),
    # never settles (a 1 mm band), without the feedthrough
    ("disturbance_rejection", dict(ee_force=20.0, settle=0.05, hold=0.1,
                                   release=0.1, warmup=2, settle_band_mm=1.0,
                                   mpc_wrench_feedthrough=False), None),
]


@pytest.mark.parametrize("name,kw,unsafe_after", PROTOCOL_CASES)
def test_host_protocol_matches_jax(monkeypatch, name, kw, unsafe_after):
    jrec, trec = [], []
    monkeypatch.setattr(JE, "ControlLoop",
                        _scripted_loop("jax", jrec, unsafe_after))
    monkeypatch.setattr(TE, "ControlLoop",
                        _scripted_loop("torch", trec, unsafe_after))
    jr = getattr(JE, name)(cfg=_ci_cfg(), **kw)
    tr = getattr(TE, name)(cfg=_tci_cfg(), device="cpu", **kw)
    _records_match(jrec, trec)
    _results_match(jr, tr)
    assert sum(r[0] == "run" for r in trec) >= 2


def test_device_rule():
    """The experiments default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (TE.traverse_ee_hold, TE.ee_tracking,
               TE.disturbance_rejection):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(cfg=_tci_cfg(), warmup=1)
