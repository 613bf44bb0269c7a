"""PyTorch port vs JAX reference: the command-driven experiments through
the real closed loop (MPC + WBC + plant) on the CPU, at a cut size:
disturbance_rejection with the MPC's wrench feedthrough, 25 N at the EE
(settling, the load and the release: 8 MPC periods at 500 Hz);
tests/test_torch_traverse_loop.py runs traverse_ee_hold the same way.

A 0.3 s / 0.03 s horizon (N = 10). Bound: every number of the result
within twice the JAX run's own spread under 1e-7 relative dust on q0
(three draws) plus a floor (0.1 mm for EE errors, 1e-4 m for
displacements, 1e-4 deg), the flags and times equal. The JAX loop is
built once per configuration and reused by the dust draws (its
compilation is most of the JAX side's time).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu import experiments as JE
from qm_control_tpu.config import MpcConfig, QmConfig
from qm_control_tpu_torch import config as TCfg
from qm_control_tpu_torch import experiments as TE

torch.set_num_threads(1)


def _cfgs(mpc_frequency=100.0):
    kw = dict(time_horizon=0.3, dt=0.03, num_iterations=1,
              mpc_frequency=mpc_frequency)
    j = QmConfig().with_(mpc=MpcConfig(**kw))
    t = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(**kw))
    return (j.with_(wbc=dataclasses.replace(j.wbc, arm_settling_time=0.0)),
            t.with_(wbc=dataclasses.replace(t.wbc, arm_settling_time=0.0)))


def _jax_runs(monkeypatch, name, jcfg, kw, draws=3):
    """The JAX experiment, then `draws` runs from q0 with 1e-7 relative
    dust; the JAX ControlLoop is built once and reused."""
    loops = {}
    jloop_cls = JE.ControlLoop

    def cached(model, info, cfg, loop_cfg, gains=None):
        key = repr((cfg, loop_cfg))
        if key not in loops:
            loops[key] = jloop_cls(model, info, cfg, loop_cfg, gains=gains)
        return loops[key]
    monkeypatch.setattr(JE, "ControlLoop", cached)
    setup = JE._standing_setup
    ref = getattr(JE, name)(cfg=jcfg, **kw)
    rng = np.random.default_rng(0)
    dusted = []
    for _ in range(draws):
        dust = 1.0 + 1e-7 * rng.standard_normal(24)

        def dusted_setup(cfg, dust=dust):
            model, info, q0, s = setup(cfg)
            return model, info, jnp.asarray(np.asarray(q0) * dust,
                                            jnp.float32), s
        monkeypatch.setattr(JE, "_standing_setup", dusted_setup)
        dusted.append(getattr(JE, name)(cfg=jcfg, **kw))
    monkeypatch.setattr(JE, "_standing_setup", setup)
    return ref, dusted


def _floor(key):
    if key.endswith("_mm"):
        return 0.1
    if key.endswith("_deg"):
        return 1e-4
    return 1e-4            # metres


def _match(ref, dusted, out, exact=()):
    ref, out = ({k: v for k, v in r.items() if k not in ("log",
                                                           "cycle_timer")}
                for r in (ref, out))
    assert out.keys() == ref.keys()
    for k, a in ref.items():
        b = out[k]
        if isinstance(a, (bool, np.bool_, str)) or a is None or k in exact:
            assert b == pytest.approx(a, abs=1e-6) if isinstance(
                a, float) else b == a, (k, a, b)
            continue
        spread = max(abs(d[k] - a) for d in dusted)
        assert abs(b - a) <= 2.0 * spread + _floor(k), (k, a, b, spread)


def test_disturbance_rejection_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs()
    kw = dict(ee_force=25.0, settle=0.02, hold=0.03, release=0.03,
              warmup=2, settle_band_mm=25.0, mpc_wrench_feedthrough=True)
    ref, dusted = _jax_runs(monkeypatch, "disturbance_rejection", jcfg, kw)
    out = TE.disturbance_rejection(cfg=tcfg, device="cpu", **kw)
    _match(ref, dusted, out, exact=("settling_time_s", "release_time_s",
                                    "ee_excursion_bound_mm",
                                    "settle_band_mm"))
    assert out["ee_excursion_max_mm"] > 0.0
