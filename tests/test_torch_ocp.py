"""PyTorch port vs JAX reference: gaits, swing references, targets, the
input map, costs and the structured stage linearization.

The same numpy inputs (drawn from seeded generators) go through both
packages. Tolerances: exact for the host-side gait schedules and mode
queries; 1e-5 absolute for the elementwise swing, target and input-map
values (f32 roundoff of short formulas); 1e-4 relative (of max(1, |ref|))
for costs and quadratic models; and the bound of tests/test_linearize.py,
2e-4 of max(1, |a|) on each of A, B, L, lx, lw, lxx, lww, lwx, for the
linearization (the port's and JAX's differ at ~5e-7 on these draws).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.config import QmConfig
from qm_control_tpu.gaits import gait as JG
from qm_control_tpu.gaits import library as JL
from qm_control_tpu.gaits import swing as JS
from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as jload
from qm_control_tpu.models.spec import default_q
from qm_control_tpu.ocp import constraints as JK
from qm_control_tpu.ocp import costs as JCo
from qm_control_tpu.ocp import reference as JR
from qm_control_tpu.ocp.linearize import make_structured_linearize as jmsl
from qm_control_tpu_torch.config import QmConfig as TQmConfig
from qm_control_tpu_torch.gaits import gait as TG
from qm_control_tpu_torch.gaits import library as TL
from qm_control_tpu_torch.gaits import swing as TS
from qm_control_tpu_torch.interop import (mode_schedule_from_numpy,
                                          target_from_numpy)
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as tload
from qm_control_tpu_torch.ocp import constraints as TK
from qm_control_tpu_torch.ocp import costs as TCo
from qm_control_tpu_torch.ocp import reference as TR
from qm_control_tpu_torch.ocp.linearize import make_structured_linearize
from qm_control_tpu_torch.ocp.problem import make_ocp as tmake_ocp

torch.set_num_threads(1)
NAMES = ["A", "B", "L", "lx", "lw", "lxx", "lww", "lwx"]


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _ms_pair(event_times, modes):
    jms = JG.mode_schedule_from_lists(event_times, modes)
    return jms, mode_schedule_from_numpy(np.asarray(jms.event_times),
                                         np.asarray(jms.modes), device="cpu")


@pytest.fixture(scope="module")
def models():
    jm, tm = jload(), tload()
    return jm, JC.make_centroidal_info(jm), tm, TC.make_centroidal_info(tm)


@pytest.fixture(scope="module")
def hold_target():
    q0 = default_q(base_pos=(0, 0, 0.38))
    s = np.zeros(37)
    s[6:30] = q0
    s[8] = 0.4
    s[30:33] = [0.52, 0.09, 0.78]
    s[33:37] = [0.5, -0.5, 0.5, -0.5]
    jt = JR.target_from_knots([0.0, 10.0], [s, s])
    return s, jt, target_from_numpy(np.asarray(jt.times),
                                    np.asarray(jt.states), device="cpu")


# ---------------------------------------------------------------- gaits ---

def test_mode_helpers_match_jax():
    for name in TG.MODE_NAMES.values():
        assert TG.mode_name_to_number(name) == JG.mode_name_to_number(name)
    for m in range(16):
        tf = TG.contact_flags_from_mode(torch.tensor(m))
        np.testing.assert_array_equal(
            tf.numpy(), np.asarray(JG.contact_flags_from_mode(m)))
        assert int(TG.mode_from_contact_flags(tf)) == m
    jms, tms = _ms_pair([0.35, 0.70, 1.05], [9, 6, 9, 6])
    ts = np.array([0.0, 0.1, 0.35, 0.5, 0.7, 0.9, 1.2, 5.0], np.float32)
    np.testing.assert_array_equal(
        TG.mode_at_time(tms, _t(ts)).numpy(),
        [int(JG.mode_at_time(jms, t)) for t in ts])
    for t in ts:
        np.testing.assert_array_equal(
            TG.contact_flags_at_time(tms, _t(t)).numpy(),
            np.asarray(JG.contact_flags_at_time(jms, t)))
    for f in range(4):
        np.testing.assert_array_equal(
            TG.foot_contact_sequence(tms, f).numpy(),
            np.asarray(JG.foot_contact_sequence(jms, f)))


def test_gait_library_matches_jax():
    assert set(TL.GAIT_LIBRARY) == set(JL.GAIT_LIBRARY)
    for name, g in TL.GAIT_LIBRARY.items():
        jg = JL.GAIT_LIBRARY[name]
        assert g.mode_sequence == jg.mode_sequence
        assert g.switching_times == jg.switching_times
        assert g.duration == pytest.approx(jg.duration)


@pytest.mark.parametrize("gait", sorted(JL.GAIT_LIBRARY))
def test_gait_schedule_matches_jax(gait):
    """Stance, then `gait` inserted at 1.0 s; two receding windows."""
    jgs, tgs = JL.GaitSchedule(), TL.GaitSchedule()
    jgs.insert_template(JL.GAIT_LIBRARY[gait], 1.0)
    tgs.insert_template(TL.GAIT_LIBRARY[gait], 1.0)
    for lo, hi in ((0.0, 3.0), (2.0, 5.5)):
        jms = jgs.mode_schedule(lo, hi)
        tms = tgs.mode_schedule(lo, hi, device="cpu")
        np.testing.assert_array_equal(tms.modes.numpy(),
                                      np.asarray(jms.modes))
        np.testing.assert_array_equal(tms.event_times.numpy(),
                                      np.asarray(jms.event_times))


def test_mode_schedule_overflow_raises_like_jax():
    """More than MAX_EVENTS events raise in both (never a silent
    truncation: 47 trot events end at 16.45 s)."""
    assert TG.MAX_EVENTS == JG.MAX_EVENTS == 47
    jgs, tgs = JL.GaitSchedule(), TL.GaitSchedule()
    jgs.insert_template(JL.GAIT_LIBRARY["trot"], 0.0)
    tgs.insert_template(TL.GAIT_LIBRARY["trot"], 0.0)
    with pytest.raises(ValueError, match="MAX_EVENTS"):
        jgs.mode_schedule(0.0, 20.0)
    with pytest.raises(ValueError, match="MAX_EVENTS"):
        tgs.mode_schedule(0.0, 20.0, device="cpu")


@pytest.mark.parametrize("foot", range(4))
def test_swing_reference_matches_jax(foot):
    jms, tms = _ms_pair([0.35, 0.70, 1.05], [9, 6, 9, 6])
    cfg = JS.SwingConfig()
    ts = np.linspace(0.0, 1.4, 57).astype(np.float32)
    z, zd = TS.swing_z_reference(tms, foot, _t(ts), 2.0, TS.SwingConfig())
    jz, jzd = jnp.vectorize(
        lambda tt: JS.swing_z_reference(jms, foot, tt, 2.0, cfg),
        signature="()->(),()")(jnp.asarray(ts))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(zd.numpy(), np.asarray(jzd), atol=1e-5)
    lo, td = TS.swing_phase_bounds(tms, foot, _t(ts), 2.0)
    for i in (0, 20, 40, 56):
        jlo, jtd = JS.swing_phase_bounds(jms, foot, ts[i], 2.0)
        assert float(lo[i]) == pytest.approx(float(jlo), abs=1e-6)
        assert float(td[i]) == pytest.approx(float(jtd), abs=1e-6)


def test_swing_reference_shape():
    """tests/test_gaits.py's checks on the port: LF swings on
    [0.35, 0.70], z starts and ends at the terrain and peaks near the
    scaled swing height, with the liftoff/touchdown velocities."""
    _, tms = _ms_pair([0.35, 0.70, 1.05], [9, 6, 9, 6])
    cfg = TS.SwingConfig()
    z, _ = TS.swing_z_reference(tms, 0, torch.linspace(0.36, 0.69, 30),
                                2.0, cfg)
    scale = min(1.0, 0.35 / cfg.swing_time_scale)
    assert abs(float(z.max()) - cfg.swing_height * scale) < 0.02
    assert abs(float(z[0])) < 0.02 and abs(float(z[-1])) < 0.02
    _, zd0 = TS.swing_z_reference(tms, 0, torch.tensor(0.35), 2.0, cfg)
    _, zd1 = TS.swing_z_reference(tms, 0, torch.tensor(0.70 - 1e-4), 2.0, cfg)
    assert float(zd0) == pytest.approx(cfg.lift_off_velocity * scale, abs=1e-3)
    assert float(zd1) == pytest.approx(cfg.touch_down_velocity * scale,
                                       abs=1e-2)


# -------------------------------------------------------------- targets ---

def test_interpolate_state_and_ee_pose_match_jax():
    rng = np.random.default_rng(3)
    states = rng.normal(0, 1, (3, 37))
    for k in range(3):
        q = rng.normal(size=4)
        states[k, 33:37] = q / np.linalg.norm(q)
    jt = JR.target_from_knots([0.2, 0.7, 0.7], states)
    tt = TR.target_from_knots([0.2, 0.7, 0.7], states, device="cpu")
    np.testing.assert_array_equal(tt.times.numpy(), np.asarray(jt.times))
    np.testing.assert_array_equal(tt.states.numpy(), np.asarray(jt.states))
    ts = np.array([0.0, 0.2, 0.33, 0.6999, 0.7, 0.9, 2e9], np.float32)
    x = TR.interpolate_state(tt, _t(ts))
    p, q = TR.interpolate_ee_pose(tt, _t(ts))
    for i, t in enumerate(ts):
        np.testing.assert_allclose(
            x[i].numpy(), np.asarray(JR.interpolate_state(jt, t)), atol=1e-5)
        jp, jq = JR.interpolate_ee_pose(jt, t)
        np.testing.assert_allclose(p[i].numpy(), np.asarray(jp), atol=1e-5)
        np.testing.assert_allclose(q[i].numpy(), np.asarray(jq), atol=1e-5)
        # one query at a time gives the same as the batch
        np.testing.assert_allclose(TR.interpolate_state(tt, _t(t)).numpy(),
                                   x[i].numpy(), atol=1e-6)


# ------------------------------------------------------------ input map ---

_FLAG_SETS = ((1, 1, 1, 1), (1, 0, 0, 1), (0, 1, 1, 0), (0, 0, 0, 0),
              (1, 1, 0, 1))


@pytest.mark.parametrize("flags", _FLAG_SETS)
def test_input_parameterization_matches_jax(models, flags):
    jm, ji, tm, ti = models
    rng = np.random.default_rng(sum(flags) + 7 * flags[1])
    x = np.zeros(30, np.float32)
    x[6:30] = default_q(base_pos=(0, 0, 0.4))
    x = (x + rng.normal(0, 0.05, 30)).astype(np.float32)
    fl = np.asarray(flags, np.float32)
    zd = rng.normal(0, 0.1, 4).astype(np.float32)
    w = rng.normal(0, 5, 30).astype(np.float32)
    jp = jax.jit(lambda x, f, z: JK.input_parameterization(jm, ji, x, f, z))(
        x, fl, zd)
    tp = TK.input_parameterization(tm, ti, _t(x), _t(fl), _t(zd))
    np.testing.assert_allclose(tp.u0.numpy(), np.asarray(jp.u0), atol=1e-5)
    np.testing.assert_allclose(tp.N.numpy(), np.asarray(jp.N), atol=1e-5)
    u = TK.apply_input_param(tp, _t(w))
    res = TK.constraint_residuals(tm, ti, _t(x), u, _t(fl), _t(zd))
    jres = JK.constraint_residuals(jm, ji, x, np.asarray(u), fl, zd)
    for k, v in res.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jres[k]), atol=1e-4)
        # the reparameterized input satisfies every active constraint
        assert float(v.abs().max()) < 1e-3, k


# ----------------------------------------------------------------- costs ---

@pytest.mark.parametrize("flags", _FLAG_SETS[:3])
def test_costs_and_quadratizer_match_jax(models, hold_target, flags):
    jm, ji, tm, ti = models
    s, jt, tt = hold_target
    cfg, tcfg = QmConfig(), TQmConfig()
    rng = np.random.default_rng(11 + sum(flags))
    x = (s[:30] + rng.normal(0, 0.05, 30)).astype(np.float32)
    u = rng.normal(0, 5, 30).astype(np.float32)
    u[2::3][:4] += 60.0                            # fz inside the cone
    fl = np.asarray(flags, np.float32)
    t = np.float32(0.3)

    jsc, jfc = JCo.make_stage_cost(jm, ji, cfg)
    jq, jfq = JCo.make_stage_quadratizer(jm, ji, cfg)
    tsc, tfc = TCo.make_stage_cost(tm, ti, tcfg)
    tq, tfq = TCo.make_stage_quadratizer(tm, ti, tcfg)
    np.testing.assert_allclose(
        TCo.input_cost_weight(tm, tcfg.cost),
        JCo.input_cost_weight(jm, cfg.cost), rtol=1e-4, atol=1e-6)

    def close(a, b):
        a, b = np.asarray(a), np.asarray(b)
        err = np.abs(a - b).max() / max(1.0, np.abs(b).max())
        assert err < 1e-4, err

    close(tsc(_t(t), _t(x), _t(u), tt, _t(fl)),
          jax.jit(lambda *a: jsc(*a, jt, fl))(t, x, u))
    close(tfc(_t(t), _t(x), tt), jax.jit(lambda *a: jfc(*a, jt))(t, x))
    for a, b in zip(tq(_t(t), _t(x), _t(u), tt, _t(fl)),
                    jax.jit(lambda *a: jq(*a, jt, fl))(t, x, u)):
        assert a.dtype == torch.float32
        close(a, b)
    for a, b in zip(tfq(_t(t), _t(x), tt),
                    jax.jit(lambda *a: jfq(*a, jt))(t, x)):
        close(a, b)
    # the parts alone, on a given EE residual and Jacobian
    e = rng.normal(0, 0.01, 6).astype(np.float32)
    Je = rng.normal(0, 0.5, (6, 30)).astype(np.float32)
    jparts = JCo.make_stage_quadratizer_parts(jm, ji, cfg)
    tparts = TCo.make_stage_quadratizer_parts(tm, ti, tcfg)
    for a, b in zip(tparts(_t(t), _t(x), _t(u), tt, _t(fl), _t(e), _t(Je)),
                    jax.jit(lambda *a: jparts(a[0], a[1], a[2], jt, fl,
                                              a[3], a[4]))(t, x, u, e, Je)):
        close(a, b)


def test_relaxed_barrier_gradient_is_finite_below_delta():
    """The log branch takes max(h, delta): no NaN gradient through where."""
    from torch.func import grad
    h = torch.tensor([-3.0, 0.0, 4.9, 5.1, 50.0])
    g = grad(lambda hh: TCo.relaxed_barrier_penalty(hh, 0.1, 5.0).sum())(h)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(
        TCo.relaxed_barrier_penalty(h, 0.1, 5.0).numpy(),
        np.asarray(JCo.relaxed_barrier_penalty(jnp.asarray(h.numpy()),
                                               0.1, 5.0)), rtol=1e-6)


# ---------------------------------------------------------- linearization ---

@pytest.fixture(scope="module")
def linearizers(models, hold_target):
    jm, ji, tm, ti = models
    _, jt, tt = hold_target
    jlin = jmsl(jm, ji, QmConfig())
    tcfg = TQmConfig()
    tad = tmake_ocp(tm, ti, tcfg.with_(mpc=dataclasses.replace(
        tcfg.mpc, structured_linearize=False))).stage_linearize
    return (jax.jit(lambda t, f, z, x, w: jlin(t, f, z, x, w, jt)),
            make_structured_linearize(tm, ti, tcfg), tad, tt)


def _draw(s, trial, rng):
    """tests/test_linearize.py:test_parity_random_states's draws."""
    x = (s[:30] + rng.normal(0, 0.05, 30)).astype(np.float32)
    w = rng.normal(0, 5, 30).astype(np.float32)
    flags = (np.ones(4, np.float32) if trial < 2 else
             rng.integers(0, 2, 4).astype(np.float32))
    zdot = rng.normal(0, 0.1, 4).astype(np.float32)
    return flags, zdot, x, w


def _compare(ref, out, bound=2e-4):
    for n, a, b in zip(NAMES, ref, out):
        a, b = np.asarray(a), b.numpy()
        assert b.dtype == np.float32, n
        err = np.abs(a - b).max() / max(1.0, np.abs(a).max())
        assert err < bound, (n, err)


def test_structured_linearize_matches_jax(linearizers, hold_target):
    """Stance and mixed contact flags at tests/test_linearize.py's states;
    the port's autodiff path (60-tangent jacfwd) agrees as well."""
    jlin, tlin, tad, tt = linearizers
    s = hold_target[0]
    rng = np.random.default_rng(0)
    for trial in range(4):
        flags, zdot, x, w = _draw(s, trial, rng)
        ref = jlin(jnp.float32(0.3), flags, zdot, x, w)
        args = (torch.tensor(0.3), _t(flags), _t(zdot), _t(x), _t(w), tt)
        out = tlin(*args)
        _compare(ref, out)
        _compare([a.numpy() for a in out], tad(*args))


def test_structured_linearize_vmapped_over_nodes(linearizers, hold_target):
    """The solver's use: torch.func.vmap over nodes equals node by node."""
    from torch.func import vmap
    _, tlin, _, tt = linearizers
    s = hold_target[0]
    rng = np.random.default_rng(5)
    draws = [_draw(s, k, rng) for k in range(3)]
    cols = [_t(np.stack(c)) for c in zip(*draws)]
    ts = torch.tensor([0.1, 0.2, 0.3])
    batched = vmap(lambda t, f, z, x, w: tlin(t, f, z, x, w, tt))(ts, *cols)
    for k in range(3):
        one = tlin(ts[k], *[c[k] for c in cols], tt)
        for a, b in zip(batched, one):
            torch.testing.assert_close(a[k], b, rtol=1e-5, atol=1e-5)
