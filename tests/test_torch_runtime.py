"""PyTorch port vs JAX reference: the runtime modules of the control tick
(plant with its delay ring, ground-truth estimator, safety predicate, MRT
policy evaluation, gait mode helpers) on the same seeded inputs.

Tolerances: f32 on both sides; three plant steps within atol 1e-5 on q
and rtol 1e-5 / atol 1e-4 on v (the implicit solve of a 24x24 system with
O(1e3) contact damping entries; the random commands drive some joint
rates to O(100) rad/s), estimator quantities within 1e-5, policy interpolation
within 1e-6; integer and boolean outputs exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.gaits import gait as JG
from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as j_load_model
from qm_control_tpu.models.spec import default_q
from qm_control_tpu.mpc.mpc import MpcPolicy as JPolicy
from qm_control_tpu.mpc.mpc import evaluate_policy as j_eval
from qm_control_tpu.runtime import estimator as JE
from qm_control_tpu.runtime import plant as JP
from qm_control_tpu.runtime.safety import safety_check as j_safe

from qm_control_tpu_torch.gaits import gait as TG
from qm_control_tpu_torch.interop import plant_state_from_numpy
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as t_load_model
from qm_control_tpu_torch.mpc.mpc import MpcPolicy as TPolicy
from qm_control_tpu_torch.mpc.mpc import evaluate_policy as t_eval
from qm_control_tpu_torch.runtime import estimator as TE
from qm_control_tpu_torch.runtime import plant as TP
from qm_control_tpu_torch.runtime.safety import safety_check as t_safe

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jm, tm = j_load_model(), t_load_model()
    return jm, tm, JC.make_centroidal_info(jm), TC.make_centroidal_info(tm)


def _qv(seed):
    rng = np.random.default_rng(seed)
    q = default_q(base_pos=(0.0, 0.0, 0.38)).astype(np.float32)
    q[:3] += rng.uniform(-0.05, 0.05, 3)
    q[3:6] = rng.uniform(-0.3, 0.3, 3)
    q[3] += 6.0 * seed          # yaw beyond 2 pi exercises the unwrap
    q[6:] += rng.uniform(-0.2, 0.2, 18)
    v = (rng.standard_normal(24) * 0.3).astype(np.float32)
    return q.astype(np.float32), v


@pytest.mark.parametrize("delay", [0, 2])
def test_plant_steps_match_jax(models, delay):
    """Three pushes and plant steps from the same state through the delay
    ring (delay 2 reads the command pushed two ticks earlier)."""
    jm, tm, _, _ = models
    rng = np.random.default_rng(delay)
    q, v = _qv(1)
    q[2] = 0.37                                  # feet in ground contact
    cfg = dict(delay_steps=delay)
    jstep = jax.jit(JP.make_plant_step(jm, JP.PlantConfig(**cfg)))
    tstep = TP.make_plant_step(tm, TP.PlantConfig(**cfg))
    js = JP.init_plant_state(q, v, model=jm)
    ts = plant_state_from_numpy(
        np.asarray(js.q), np.asarray(js.v), np.asarray(js.t),
        [np.asarray(b) for b in js.cmd_buf], np.asarray(js.buf_head),
        np.asarray(js.anchors), np.asarray(js.ee_wrench), device="cpu")
    for _ in range(3):
        cmd = [rng.standard_normal(18).astype(np.float32) * s
               for s in (0.1, 0.1, 20.0, 2.0, 5.0)]
        js = JP.push_command(js, JP.HybridCommand(*map(jnp.asarray, cmd)))
        ts = TP.push_command(ts, TP.HybridCommand(*map(torch.as_tensor, cmd)))
        js, jfc = jstep(js)
        ts, tfc = tstep(ts)
    assert int(ts.buf_head) == int(js.buf_head) == 3
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ts.anchors.numpy(), np.asarray(js.anchors),
                               atol=1e-5)
    np.testing.assert_allclose(tfc.numpy(), np.asarray(jfc), atol=1e-2)
    assert TP.delay_steps_for(0.009, 1000.0) == JP.delay_steps_for(0.009,
                                                                  1000.0)


@pytest.mark.parametrize("seed", range(4))
def test_estimator_matches_jax(models, seed):
    jm, tm, ji, ti = models
    q, v = _qv(seed)
    jr = JE.rbd_state_from_plant(jm, jnp.asarray(q), jnp.asarray(v))
    tr = TE.rbd_state_from_plant(tm, torch.as_tensor(q), torch.as_tensor(v))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    for a, b in zip(TE.rbd_to_qv(tr), JE.rbd_to_qv(jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    last_yaw = np.float32(0.1)
    jx = JE.observation_from_rbd(jm, ji, jr, jnp.asarray(last_yaw))
    tx = TE.observation_from_rbd(tm, ti, tr, torch.as_tensor(last_yaw))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert abs(float(tx[9]) - last_yaw) <= np.pi + 1e-5


def test_safety_matches_jax():
    rng = np.random.default_rng(5)
    for k in range(12):
        x = rng.standard_normal(30).astype(np.float32) * 0.5
        x[8] = [0.4, 0.05, 1.2][k % 3]
        x[11] = [0.1, 2.0][k % 2]
        if k == 7:
            x[3] = np.nan
        cost = np.float32([0.0, np.inf][k % 5 == 4])
        assert bool(t_safe(torch.as_tensor(x), torch.as_tensor(cost))) == \
            bool(j_safe(jnp.asarray(x), jnp.asarray(cost)))


def test_evaluate_policy_and_gait_match_jax():
    rng = np.random.default_rng(2)
    n = 12
    tn = np.cumsum(rng.uniform(0.01, 0.03, n)).astype(np.float32)
    X = rng.standard_normal((n, 30)).astype(np.float32)
    U = rng.standard_normal((n, 30)).astype(np.float32)
    modes = rng.integers(0, 16, n).astype(np.int32)
    z = np.float32(0.0)
    jp = JPolicy(*map(jnp.asarray, (tn, X, U, modes, z, X[:-1], z, z)))
    tp = TPolicy(*map(torch.as_tensor, (tn, X, U, modes, z, X[:-1], z, z)))
    for t in (-0.1, 0.0, float(tn[3]), 0.5 * float(tn[4] + tn[5]), 9.0):
        for a, b in zip(t_eval(tp, torch.tensor(t)), j_eval(jp, t)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    times, ms = [0.1, 0.25, 0.4], [15, 9, 6, 15]
    jms = JG.mode_schedule_from_lists(times, ms)
    tms = TG.mode_schedule_from_lists(times, ms, device="cpu")
    for t in (0.0, 0.1, 0.2, 0.3, 0.45):
        mode = TG.mode_at_time(tms, t)
        assert int(mode) == int(JG.mode_at_time(jms, t))
        np.testing.assert_array_equal(
            TG.contact_flags_from_mode(mode).numpy(),
            np.asarray(JG.contact_flags_from_mode(int(mode))))
        assert int(TG.mode_from_contact_flags(
            TG.contact_flags_from_mode(mode))) == int(mode)
