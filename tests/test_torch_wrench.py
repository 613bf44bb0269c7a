"""PyTorch port vs JAX reference: the EE-wrench feedthrough of the MPC
dynamics, through every layer, and ControlLoop.escape.

From the same numpy inputs (seeded draws) in both packages:
  - centroidal.flow_map with a world wrench at the EE, within 1e-6 of
    max(1, |f|);
  - the structured stage_linearize with a wrench (the extra
    -skew(w_f) (J_ee - J_com) / m rows and the EE Jacobian at the RK2
    midpoint), within 7e-7 of max(1, |a|) on each output against JAX and
    against the port's own autodiff path (structured_linearize=False);
  - mpc_step(ee_wrench=) at tests/test_experiments.py's _ci_cfg, cold then
    warm, at the MPC bounds of tests/test_torch_mpc.py (cost 1e-3
    relative, X 2e-3, W 0.5 N), and the wrench moves the plan by more
    than those bounds;
  - two make_cycle periods with mpc_wrench_feedthrough and a 25 N lateral
    plant wrench, under the dust-band rule of tests/test_torch_loop.py
    (twice the JAX loop's own spread under 1e-7 dust on q0, six draws,
    plus that file's floors; JAX with fused_wbc=True).
ControlLoop.escape is held against JAX in tests/test_torch_escape.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.config import MpcConfig, QmConfig
from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as jload
from qm_control_tpu.mpc.mpc import mpc_step as jmpc_step
from qm_control_tpu.ocp.linearize import make_structured_linearize as jmsl
from qm_control_tpu.ocp.problem import make_ocp as jmake_ocp
from qm_control_tpu.solver.sqp import SqpSettings as JSqpSettings
from qm_control_tpu_torch.config import QmConfig as TQmConfig
from qm_control_tpu_torch.interop import cycle_carry_from_numpy
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as tload
from qm_control_tpu_torch.mpc.mpc import mpc_step
from qm_control_tpu_torch.ocp.linearize import make_structured_linearize
from qm_control_tpu_torch.ocp.problem import make_ocp
from qm_control_tpu_torch.solver.sqp import SqpSettings
from test_experiments import _ci_cfg
from test_torch_loop import (_METRIC_FLOORS, _OUT_FLOORS, _cycle_out, _gaps,
                             _leaves, _schedule, _tcfg, _within)
from test_torch_mpc import _close as _mpc_close
from test_torch_mpc import _standing
from test_torch_ocp import NAMES, _draw, _t

torch.set_num_threads(1)
# disturbance_rejection's 25 N lateral force at the EE
WRENCH = np.float32([0.0, -25.0, 0.0, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module")
def models():
    jm, tm = jload(), tload()
    return jm, JC.make_centroidal_info(jm), tm, TC.make_centroidal_info(tm)


def _wrench(rng):
    return np.concatenate([rng.normal(0, 20, 3),
                           rng.normal(0, 3, 3)]).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_flow_map_with_wrench_matches_jax(models, seed):
    jm, ji, tm, ti = models
    _, s = _standing(0.38)
    rng = np.random.default_rng(seed)
    x = (s[:30] + rng.normal(0, 0.05, 30)).astype(np.float32)
    u = (rng.standard_normal(30) * 20.0).astype(np.float32)
    w = _wrench(rng)
    ref = np.asarray(JC.flow_map(jm, ji, jnp.asarray(x), jnp.asarray(u),
                                 ee_wrench=jnp.asarray(w)))
    out = TC.flow_map(tm, ti, _t(x), _t(u), ee_wrench=_t(w)).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max())
    # the wrench enters: f_total / m and the EE lever arm's torque
    free = TC.flow_map(tm, ti, _t(x), _t(u)).numpy()
    np.testing.assert_allclose(out[:3] - free[:3], w[:3] / ti.mass,
                               atol=1e-5)
    assert np.abs(out[3:6] - free[3:6]).max() > 1e-3


@pytest.fixture(scope="module")
def linearizers(models):
    jm, ji, tm, ti = models
    _, s = _standing(0.38)
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu_torch.interop import target_from_numpy
    s = s.copy()
    s[8] = 0.4
    jt = target_from_knots([0.0, 10.0], [s, s])
    tt = target_from_numpy(np.asarray(jt.times), np.asarray(jt.states),
                           device="cpu")
    jlin = jmsl(jm, ji, QmConfig())
    tcfg = TQmConfig()
    tad = make_ocp(tm, ti, tcfg.with_(mpc=dataclasses.replace(
        tcfg.mpc, structured_linearize=False))).stage_linearize
    return (jax.jit(lambda t, f, z, x, w, wr: jlin(t, f, z, x, w, jt,
                                                   ee_wrench=wr)),
            make_structured_linearize(tm, ti, tcfg), tad, tt, s)


def _compare(ref, out, bounds=None):
    for n, a, b in zip(NAMES, ref, out):
        a, b = np.asarray(a), np.asarray(b)
        assert b.dtype == np.float32, n
        err = np.abs(a - b).max() / max(1.0, np.abs(a).max())
        assert err <= (bounds or {}).get(n, 7e-7), (n, err)


@pytest.mark.parametrize("trial", range(4))
def test_stage_linearize_with_wrench_matches_jax(linearizers, trial):
    """Stance and mixed contact flags at tests/test_linearize.py's states,
    each with a seeded wrench: the structured path against JAX and against
    the port's autodiff path. The wrench enters A and B only: the cost
    model (L ... lwx) is the same with and without it in both packages.
    Its gradient lx differs from JAX's by up to 2.14e-6 of max(1, |lx|)
    on these draws with or without the wrench (f32 roundoff of the cost
    gradient, held by tests/test_torch_ocp.py), so lx alone is held to
    2.5e-6; every other output to 7e-7."""
    jlin, tlin, tad, tt, s = linearizers
    rng = np.random.default_rng(trial)
    flags, zdot, x, w = _draw(s, trial, rng)
    wr = _wrench(rng)
    ref = jlin(jnp.float32(0.3), flags, zdot, x, w, jnp.asarray(wr))
    args = (torch.tensor(0.3), _t(flags), _t(zdot), _t(x), _t(w), tt)
    out = [a.numpy() for a in tlin(*args, ee_wrench=_t(wr))]
    _compare(ref, out, {"lx": 2.5e-6})
    _compare(out, [a.numpy() for a in tad(*args, ee_wrench=_t(wr))])
    free = [a.numpy() for a in tlin(*args)]
    jfree = jlin(jnp.float32(0.3), flags, zdot, x, w, None)
    for k in range(2, 8):
        np.testing.assert_array_equal(out[k], free[k])
        np.testing.assert_array_equal(np.asarray(ref[k]),
                                      np.asarray(jfree[k]))
    assert np.abs(out[0] - free[0]).max() > 1e-5      # A moves


def _ci_pair():
    cfg = _ci_cfg()
    return cfg, _tcfg(cfg.mpc.time_horizon, cfg.mpc.dt,
                      cfg.mpc.num_iterations)


def test_mpc_step_with_wrench_matches_jax(models):
    """mpc_step(ee_wrench=) cold at the stance hold, then warm-started 10
    ms later from its own solution at a perturbed state."""
    from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu_torch.interop import (mode_schedule_from_numpy,
                                              target_from_numpy)
    jm, ji, tm, ti = models
    jcfg, tcfg = _ci_pair()
    x0, s = _standing(0.38)
    jt = target_from_knots([0.0, 10.0], [s, s])
    jms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 10.0)
    tt = target_from_numpy(np.asarray(jt.times), np.asarray(jt.states),
                           device="cpu")
    tms = mode_schedule_from_numpy(np.asarray(jms.event_times),
                                   np.asarray(jms.modes), device="cpu")
    jocp = jmake_ocp(jm, ji, jcfg)
    jstep = jax.jit(lambda t, x, W, X, sh, c, wr: jmpc_step(
        jocp, jm, ji, jcfg, JSqpSettings(num_iterations=1), t, x, jt, jms,
        W, X, sh, c, ee_wrench=wr))
    tocp = make_ocp(tm, ti, tcfg)

    def tstep(t, x, W, X, sh, c, wr):
        return mpc_step(tocp, tm, ti, tcfg, SqpSettings(num_iterations=1),
                        torch.tensor(t), torch.tensor(x), tt, tms, W, X,
                        torch.tensor(sh), torch.tensor(c), ee_wrench=wr)
    N = tcfg.mpc.num_nodes
    wr = _t(WRENCH)
    jp1 = jstep(0.0, x0, jnp.zeros((N, 30)), jnp.zeros((N + 1, 30)), 0.0,
                True, jnp.asarray(WRENCH))
    tp1 = tstep(0.0, x0, torch.zeros(N, 30), torch.zeros(N + 1, 30), 0.0,
                True, wr)
    _mpc_close(jp1, tp1)
    x1 = x0.copy()
    x1[:3] += np.float32([0.02, -0.01, 0.01])
    jp2 = jstep(0.01, x1, jp1.W, jp1.X, 0.01, False, jnp.asarray(WRENCH))
    tp2 = tstep(0.01, x1, tp1.W, tp1.X, 0.01, False, wr)
    _mpc_close(jp2, tp2)
    # the wrench is felt: the plan without it differs beyond the bounds
    free = tstep(0.0, x0, torch.zeros(N, 30), torch.zeros(N + 1, 30), 0.0,
                 True, None)
    assert float((free.W - tp1.W).abs().max()) > 0.5


@pytest.fixture(scope="module")
def wrench_loops():
    """The JAX ControlLoop of tests/test_torch_loop.py (0.3 s / 0.03 s,
    2 iterations, 1 kHz ticks, fused_wbc=True) with the feedthrough on,
    its carry 0 with the 25 N plant wrench, and the port's loop."""
    from qm_control_tpu.experiments import _standing_setup
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu.runtime.loop import ControlLoop as JLoop
    from qm_control_tpu.runtime.loop import LoopConfig as JLoopConfig
    from qm_control_tpu_torch.interop import target_from_numpy
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    jcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.3, dt=0.03,
                                          num_iterations=2))
    jcfg = jcfg.with_(wbc=dataclasses.replace(jcfg.wbc,
                                              arm_settling_time=0.0))
    model, info, q0, s = _standing_setup(jcfg)
    jloop = JLoop(model, info, jcfg, JLoopConfig(
        control_freq=1000.0, fused_wbc=True, mrt_policy_lag=1,
        mpc_wrench_feedthrough=True))
    target = target_from_knots([0.0, 9.0], [s, s])
    c0 = jloop.init_carry(q0)
    c0 = c0._replace(plant=c0.plant._replace(ee_wrench=jnp.asarray(WRENCH)))
    tm = tload()
    tloop = ControlLoop(tm, TC.make_centroidal_info(tm), _tcfg(0.3, 0.03, 2),
                        LoopConfig(control_freq=1000.0, mrt_policy_lag=1,
                                   mpc_wrench_feedthrough=True),
                        device="cpu")
    ttarget = target_from_numpy(np.asarray(target.times),
                                np.asarray(target.states), device="cpu")
    return jloop, q0, target, c0, tloop, ttarget


def test_two_feedthrough_cycles_match_jax(wrench_loops):
    """Two make_cycle periods with the feedthrough on and the wrench on
    the plant: the fresh policies, the ticks and every CycleMetrics field
    within the dust-band rule."""
    jloop, q0, target, jcarry0, tloop, ttarget = wrench_loops
    ms, tms = _schedule("stance")

    def jax_two(c0):
        c1, m1 = jloop._cycle(c0, target, ms, jloop.gains)
        c2, m2 = jloop._cycle(c1, target, ms, jloop.gains)
        return (c1, m1), (c2, m2)

    ref = jax_two(jcarry0)
    rng = np.random.default_rng(1)
    band = [np.zeros(6), np.zeros(6)]
    mband = [{k: 0.0 for k in _METRIC_FLOORS} for _ in range(2)]
    for _ in range(6):
        qd = np.asarray(q0) * (1.0 + 1e-7 * rng.standard_normal(24))
        dusted = jax_two(jcarry0._replace(plant=jcarry0.plant._replace(
            q=jnp.asarray(qd, jnp.float32))))
        for k in range(2):
            band[k] = np.maximum(band[k], _gaps(_cycle_out(*ref[k]),
                                                _cycle_out(*dusted[k])))
            for f in _METRIC_FLOORS:
                mband[k][f] = max(mband[k][f], float(np.abs(
                    np.asarray(getattr(ref[k][1], f), np.float64)
                    - np.asarray(getattr(dusted[k][1], f),
                                 np.float64)).max()))
    carry = cycle_carry_from_numpy(_leaves(jcarry0), device="cpu")
    assert carry.plant.ee_wrench.tolist() == WRENCH.tolist()
    for k in range(2):
        carry, m = tloop.run(carry, ttarget, tms, num_cycles=1)
        pm = type(m)(*[a[0] for a in m])
        jc, jm = ref[k]
        gaps = _gaps(_cycle_out(jc, jm), _cycle_out(carry, pm))
        gaps[0] /= max(1.0, abs(float(jm.mpc_cost)))
        _within(gaps, band[k], _OUT_FLOORS, f"cycle {k + 1}")
        mg = {f: float(np.abs(np.asarray(getattr(jm, f), np.float64)
                              - getattr(pm, f).numpy().astype(np.float64)
                              ).max()) for f in _METRIC_FLOORS}
        _within(list(mg.values()), list(mband[k].values()),
                list(_METRIC_FLOORS.values()), f"metrics {k + 1}: {mg}")
        assert bool(pm.safe) == bool(jm.safe) is True
    # the feedthrough is felt: the fresh cycle-1 plan differs without it
    jc1 = ref[0][0]
    no_ft = jloop._cycle(jcarry0._replace(plant=jcarry0.plant._replace(
        ee_wrench=jnp.zeros(6))), target, ms, jloop.gains)[0]
    assert float(jnp.abs(no_ft.policy.W - jc1.policy.W).max()) > 0.5


def test_device_rule(models):
    """ControlLoop with the feedthrough defaults to the card."""
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tm, ti = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ControlLoop(tm, ti, _tcfg(0.3, 0.03, 1),
                    LoopConfig(mpc_wrench_feedthrough=True))
