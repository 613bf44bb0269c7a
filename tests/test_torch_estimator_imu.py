"""PyTorch port vs JAX reference: the IMU half of runtime/estimator.py
(ImuEstimatorState, init_imu_estimator, imu_estimator_update,
imu_from_plant) and the rotations it needs (rot_x/y/z, R_to_euler_zyx),
on the same seeded inputs.

Tolerances: rbdState, observation and estimator memory within 1e-5, the
global angular rate within 1e-4 (tests/test_estimator.py:90-91 holds it
there: it goes through a 3x3 solve); the IMU sample within 1e-6, noiseless
and with the draws jax.random made injected; modes exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as j_load_model
from qm_control_tpu.models import rotations as JR
from qm_control_tpu.models.spec import default_q
from qm_control_tpu.runtime import estimator as JE

from qm_control_tpu_torch.interop import imu_estimator_state_from_numpy
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as t_load_model
from qm_control_tpu_torch.models import rotations as TR
from qm_control_tpu_torch.runtime import estimator as TE

torch.set_num_threads(1)

OMEGA = slice(24, 27)


@pytest.fixture(scope="module")
def models():
    jm, tm = j_load_model(), t_load_model()
    return jm, tm, JC.make_centroidal_info(jm), TC.make_centroidal_info(tm)


def _state(rng):
    q = default_q(base_pos=(0.0, 0.0, 0.38)).astype(np.float32)
    q[:3] += rng.uniform(-0.05, 0.05, 3)
    q[3:6] = rng.uniform(-0.4, 0.4, 3)
    q[6:] += rng.uniform(-0.2, 0.2, 18)
    v = (rng.standard_normal(24) * 0.5).astype(np.float32)
    flags = (rng.uniform(size=4) > 0.3).astype(np.float32)
    return q.astype(np.float32), v, flags


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def _check_rbd(trbd, jrbd):
    t, j = trbd.numpy(), np.asarray(jrbd)
    rest = np.r_[0:24, 27:55]
    _close(t[rest], j[rest], 1e-5)
    _close(t[OMEGA], j[OMEGA], 1e-4)


def test_rotations_match_jax():
    a = np.random.default_rng(0).uniform(-3, 3, (5,)).astype(np.float32)
    for jf, tf in ((JR.rot_x, TR.rot_x), (JR.rot_y, TR.rot_y),
                   (JR.rot_z, TR.rot_z)):
        _close(tf(torch.as_tensor(a)), jf(jnp.asarray(a)), 1e-6)
    zyx = np.random.default_rng(1).uniform(-1.2, 1.2, (6, 3)).astype(
        np.float32)
    R = np.array(JR.euler_zyx_to_R(jnp.asarray(zyx)))
    got = TR.R_to_euler_zyx(torch.as_tensor(R))
    _close(got, JR.R_to_euler_zyx(jnp.asarray(R)), 1e-6)
    _close(got, zyx, 1e-5)


def _sequence(seed, n=5):
    rng = np.random.default_rng(seed)
    return [_state(rng) for _ in range(n)]


def _jax_step(jm, est, q, v, flags):
    quat, gyro = JE.imu_from_plant(jm, jnp.asarray(q), jnp.asarray(v))
    return JE.imu_estimator_update(jm, est, quat, gyro, q[6:], v[6:], q[:3],
                                   v[:3], jnp.asarray(flags))


def _torch_step(tm, est, q, v, flags):
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    quat, gyro = TE.imu_from_plant(tm, qt, vt)
    return TE.imu_estimator_update(tm, est, quat, gyro, qt[6:], vt[6:],
                                   qt[:3], vt[:3], torch.as_tensor(flags))


@pytest.mark.parametrize("seed", [0, 1])
def test_estimator_sequence_latches_offset(models, seed):
    """Five samples: the first latches its ZYX angles as the offset, every
    later sample is reported relative to it."""
    jm, tm, ji, ti = models
    jest, test_ = JE.init_imu_estimator(), TE.init_imu_estimator(
        device="cpu")
    seq = _sequence(seed)
    for k, (q, v, flags) in enumerate(seq):
        jrbd, jmode, jest = _jax_step(jm, jest, q, v, flags)
        trbd, tmode, test_ = _torch_step(tm, test_, q, v, flags)
        _check_rbd(trbd, jrbd)
        assert int(tmode) == int(jmode)
        _close(test_.zyx_offset, jest.zyx_offset, 1e-5)
        assert float(test_.initialized) == float(jest.initialized) == 1.0
        # the offset is the first sample's orientation
        _close(test_.zyx_offset, seq[0][0][3:6], 1e-5)
        if k == 0:
            _close(trbd[0:3], np.zeros(3), 1e-6)
        # the observation the hardware loop hands the MPC
        _close(TE.observation_from_rbd(tm, ti, trbd),
               JE.observation_from_rbd(jm, ji, jrbd), 1e-4)


def test_state_carries_across_from_jax(models):
    """A JAX ImuEstimatorState, converted by interop, continues the
    sequence as the port's own state does."""
    jm, tm, _, _ = models
    seq = _sequence(3, n=3)
    jest = JE.init_imu_estimator()
    for q, v, flags in seq[:2]:
        _, _, jest = _jax_step(jm, jest, q, v, flags)
    test_ = imu_estimator_state_from_numpy(np.asarray(jest.zyx_offset),
                                           np.asarray(jest.initialized),
                                           device="cpu")
    assert test_.zyx_offset.dtype == torch.float32
    q, v, flags = seq[2]
    jrbd, _, jest2 = _jax_step(jm, jest, q, v, flags)
    trbd, _, test2 = _torch_step(tm, test_, q, v, flags)
    _check_rbd(trbd, jrbd)
    _close(test2.zyx_offset, jest2.zyx_offset, 1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_imu_from_plant_noiseless(models, seed):
    jm, tm, _, _ = models
    q, v, _ = _state(np.random.default_rng(10 + seed))
    jquat, jgyro = JE.imu_from_plant(jm, jnp.asarray(q), jnp.asarray(v))
    tquat, tgyro = TE.imu_from_plant(tm, torch.as_tensor(q),
                                     torch.as_tensor(v))
    _close(tquat, jquat, 1e-6)
    _close(tgyro, jgyro, 1e-6)


@pytest.mark.parametrize("sigmas", [(0.01, 0.02), (0.5, 0.3)])
def test_imu_noise_formula_with_jax_draws(models, sigmas):
    """The noisy formula, fed the standard-normal draws jax.random made
    from the key (k1 for the gyro, k2 for the orientation)."""
    jm, tm, _, _ = models
    q, v, _ = _state(np.random.default_rng(20))
    key = jax.random.PRNGKey(7)
    gs, qs = sigmas
    jquat, jgyro = JE.imu_from_plant(jm, jnp.asarray(q), jnp.asarray(v),
                                     rng_noise=key, gyro_sigma=gs,
                                     quat_sigma=qs)
    k1, k2 = jax.random.split(key)
    n1 = np.array(jax.random.normal(k1, (3,), dtype=jnp.float32))
    n2 = np.array(jax.random.normal(k2, (3,), dtype=jnp.float32))
    quat, gyro = TE.imu_from_plant(tm, torch.as_tensor(q), torch.as_tensor(v))
    tquat, tgyro = TE.apply_imu_noise(quat, gyro, torch.as_tensor(n1),
                                      torch.as_tensor(n2), gs, qs)
    _close(tquat, jquat, 1e-6)
    _close(tgyro, jgyro, 1e-6)


def test_generator_noise_and_the_zero_sigma_quirk(models):
    """imu_from_plant draws from the generator (gyro first); with the
    default sigmas of 0 — what SimHardware passes, as JAX's SimHardware
    does — the sample equals the noiseless one, in JAX too."""
    jm, tm, _, _ = models
    q, v, _ = _state(np.random.default_rng(30))
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    quat, gyro = TE.imu_from_plant(tm, qt, vt)
    gen = torch.Generator().manual_seed(5)
    g_draw, q_draw = (torch.randn(3, generator=gen) for _ in range(2))
    want = TE.apply_imu_noise(quat, gyro, g_draw, q_draw, 0.1, 0.2)
    got = TE.imu_from_plant(tm, qt, vt, torch.Generator().manual_seed(5),
                            gyro_sigma=0.1, quat_sigma=0.2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    zero = TE.imu_from_plant(tm, qt, vt, torch.Generator().manual_seed(5))
    for a, b in zip(zero, (quat, gyro)):
        assert torch.equal(a, b)
    jzero = JE.imu_from_plant(jm, jnp.asarray(q), jnp.asarray(v),
                              rng_noise=jax.random.PRNGKey(0))
    jplain = JE.imu_from_plant(jm, jnp.asarray(q), jnp.asarray(v))
    for a, b in zip(jzero, jplain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_init_device_rule():
    est = TE.init_imu_estimator(device="cpu")
    assert est.zyx_offset.shape == (3,) and float(est.initialized) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.init_imu_estimator()
