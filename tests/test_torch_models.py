"""PyTorch port vs JAX reference: model layer (spec, rotations, kinematics,
dynamics, centroidal helpers) on the same seeded inputs.

Tolerances (f32 on both sides; the two frameworks sum in different
orders): rtol 1e-4 / atol 1e-4 on kinematic and inertial quantities,
atol 1e-3 on quantities derived through M-dot (h, Jdot v), whose
24-term contractions of O(10) entries carry ~1e-5 relative noise.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import dynamics as JD
from qm_control_tpu.models import kinematics as JK
from qm_control_tpu.models import load_model as j_load_model
from qm_control_tpu.models import rotations as JR
from qm_control_tpu.models.spec import default_q as j_default_q
from qm_control_tpu.models.spec import DEFAULT_MODEL_JSON as J_JSON

from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import dynamics as TD
from qm_control_tpu_torch.models import kinematics as TK
from qm_control_tpu_torch.models import load_model as t_load_model
from qm_control_tpu_torch.models import rotations as TR
from qm_control_tpu_torch.models.spec import DEFAULT_MODEL_JSON as T_JSON
from qm_control_tpu_torch.models.spec import default_q as t_default_q

torch.set_num_threads(1)

SEEDS = range(8)
JDOT_FRAMES = ("j2n6s300_end_effector", "LF_FOOT", "base")


@pytest.fixture(scope="module")
def models():
    return j_load_model(), t_load_model()


@pytest.fixture(scope="module")
def jfn(models):
    """The JAX side, jitted once per module (eager JAX dispatch would
    dominate the file's run time)."""
    jm = models[0]
    return dict(
        fk=jax.jit(lambda q: JK.fk(jm, q)),
        frame_kinematics=jax.jit(lambda q: JK.frame_kinematics(jm, q)),
        contact_positions=jax.jit(lambda q: JK.contact_positions(jm, q)),
        jdot=jax.jit(lambda q, v: [JK.frame_jacobian_dot(jm, q, v, n)
                                   for n in JDOT_FRAMES]
                     + [JK.stacked_contact_jacobian_dot(jm, q, v)]),
        rbd_suite=jax.jit(lambda q: JD.rbd_suite(jm, q)),
        dyn=jax.jit(lambda q, v: (JD.mass_matrix(jm, q),
                                  JD.gravity_vector(jm, q),
                                  JD.nonlinear_effects(jm, q, v),
                                  JD.centroidal_momentum_matrix_dot(jm, q,
                                                                    v))))


@pytest.fixture(scope="module")
def infos(models):
    jm, tm = models
    return JC.make_centroidal_info(jm), TC.make_centroidal_info(tm)


def _qv(seed):
    rng = np.random.default_rng(seed)
    q = j_default_q(base_pos=(0.0, 0.0, 0.4)).astype(np.float32)
    q[:3] += rng.uniform(-0.2, 0.2, 3)
    q[3:6] = rng.uniform(-0.4, 0.4, 3)
    q[6:] += rng.uniform(-0.3, 0.3, 18)
    v = rng.standard_normal(24).astype(np.float32) * 0.5
    return q.astype(np.float32), v


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _close(t_val, j_val, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(np.asarray(t_val.detach() if
                                          isinstance(t_val, torch.Tensor)
                                          else t_val),
                               np.asarray(j_val), rtol=rtol, atol=atol)


def test_model_json_is_byte_identical():
    assert os.path.basename(T_JSON) == os.path.basename(J_JSON)
    assert filecmp.cmp(T_JSON, J_JSON, shallow=False)


def test_spec_arrays_match(models):
    jm, tm = models
    for name in ("joint_type", "parent", "X_tree_R", "X_tree_p", "axis",
                 "mass", "com", "inertia", "ancestor", "joint_effort",
                 "joint_lower", "joint_upper", "joint_velocity"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert tm.total_mass == jm.total_mass
    assert set(tm.frames) == set(jm.frames)
    np.testing.assert_array_equal(t_default_q((0, 0, 0.38)),
                                  j_default_q((0, 0, 0.38)))


@pytest.mark.parametrize("name", [
    "euler_zyx_to_R", "euler_zyx_rate_to_omega_world_matrix",
    "omega_world_to_euler_zyx_rate_matrix", "skew", "R_to_quat_roundtrip",
    "so3_log", "quat_to_R", "yaw_unwrap"])
def test_rotations(name):
    rng = np.random.default_rng(11)
    zyx = rng.uniform(-1.2, 1.2, (8, 3)).astype(np.float32)
    if name == "R_to_quat_roundtrip":
        jv = JR.R_to_quat(JR.euler_zyx_to_R(jnp.asarray(zyx)))
        tv = TR.R_to_quat(TR.euler_zyx_to_R(_t(zyx)))
    elif name == "so3_log":
        jv = JR.rotation_error_world(JR.euler_zyx_to_R(jnp.asarray(zyx)),
                                     JR.euler_zyx_to_R(jnp.asarray(zyx[::-1])))
        tv = TR.rotation_error_world(TR.euler_zyx_to_R(_t(zyx)),
                                     TR.euler_zyx_to_R(_t(zyx[::-1].copy())))
    elif name == "quat_to_R":
        qs = rng.standard_normal((8, 4)).astype(np.float32)
        jv, tv = JR.quat_to_R(jnp.asarray(qs)), TR.quat_to_R(_t(qs))
    elif name == "yaw_unwrap":
        y = rng.uniform(-7, 7, 8).astype(np.float32)
        last = rng.uniform(-7, 7, 8).astype(np.float32)
        jv = JR.yaw_unwrap(jnp.asarray(y), jnp.asarray(last))
        tv = TR.yaw_unwrap(_t(y), _t(last))
    else:
        jv = getattr(JR, name)(jnp.asarray(zyx))
        tv = getattr(TR, name)(_t(zyx))
    _close(tv, jv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_fk_jacobians_and_jdot(models, jfn, seed):
    tm = models[1]
    q, v = _qv(seed)
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    jc, tc = jfn["fk"](jq), TK.fk(tm, _t(q))
    for k in ("R", "p", "a", "o"):
        _close(tc[k], jc[k])
    for a, b in zip(TK.frame_kinematics(tm, _t(q)),
                    jfn["frame_kinematics"](jq)):
        _close(a, b)
    _close(TK.contact_positions(tm, _t(q)), jfn["contact_positions"](jq))
    tdots = [TK.frame_jacobian_dot(tm, _t(q), _t(v), n) for n in JDOT_FRAMES]
    tdots.append(TK.stacked_contact_jacobian_dot(tm, _t(q), _t(v)))
    for a, b in zip(tdots, jfn["jdot"](jq, jv)):
        _close(a, b, atol=1e-3)


@pytest.mark.parametrize("seed", SEEDS)
def test_rbd_suite_and_dynamics(models, jfn, seed):
    tm = models[1]
    q, v = _qv(seed)
    for a, b in zip(TD.rbd_suite(tm, _t(q)), jfn["rbd_suite"](jnp.asarray(q))):
        _close(a, b)
    jM, jg, jh, jAdot = jfn["dyn"](jnp.asarray(q), jnp.asarray(v))
    _close(TD.mass_matrix(tm, _t(q)), jM)
    _close(TD.gravity_vector(tm, _t(q)), jg, atol=1e-3)
    _close(TD.nonlinear_effects(tm, _t(q), _t(v)), jh, atol=1e-3)
    _close(TD.centroidal_momentum_matrix_dot(tm, _t(q), _t(v)), jAdot,
           atol=1e-3)


def test_centroidal_info(infos):
    ji, ti = infos
    assert ti.mass == ji.mass
    _close(ti.r_com_base, ji.r_com_base, atol=1e-5)
    _close(ti.I_com_base, ji.I_com_base, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_centroidal_helpers(models, infos, seed):
    jm, tm = models
    ji, ti = infos
    q, v = _qv(seed)
    rng = np.random.default_rng(100 + seed)
    x = np.concatenate([rng.standard_normal(6).astype(np.float32) * 0.3, q])
    u = rng.standard_normal(30).astype(np.float32) * 20.0
    _close(TC.centroidal_state_from_rbd(tm, ti, _t(q), _t(v)),
           JC.centroidal_state_from_rbd(jm, ji, jnp.asarray(q),
                                        jnp.asarray(v)))
    _close(TC.base_velocity_from_momentum(ti, _t(x)),
           JC.base_velocity_from_momentum(ji, jnp.asarray(x)))
    _close(TC.flow_map(tm, ti, _t(x), _t(u)),
           JC.flow_map(jm, ji, jnp.asarray(x), jnp.asarray(u)), atol=1e-3)
    _close(TC.com_position_srbd(ti, _t(x)),
           JC.com_position_srbd(ji, jnp.asarray(x)))
    flags = rng.integers(0, 2, 4)
    _close(TC.weight_compensating_input(ti, torch.as_tensor(flags)),
           JC.weight_compensating_input(ji, jnp.asarray(flags)))
