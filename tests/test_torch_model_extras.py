"""PyTorch port vs JAX reference: the model functions that no control path
of the port calls (dynamics.forward_dynamics; centroidal.
linearize_flow_map, rbd_velocity_from_centroidal,
full_centroidal_state_from_rbd; kinematics.fk_unrolled, frame_velocity,
leg_chain_fk, foot_kinematics, ee_chain_pose), each on 4 seeded draws.

Tolerance: every output within 1e-5 of max(1, |JAX's value|), and
forward_dynamics within 1e-4 of it (a solve through the mass matrix of
terms that carry M-dot: tests/test_torch_models.py holds h at 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import dynamics as JD
from qm_control_tpu.models import kinematics as JK
from qm_control_tpu.models import load_model as j_load_model
from qm_control_tpu.models.spec import EE_FRAME, default_q

from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import dynamics as TD
from qm_control_tpu_torch.models import kinematics as TK
from qm_control_tpu_torch.models import load_model as t_load_model

torch.set_num_threads(1)

SEEDS = range(4)
FUNCTIONS = ("forward_dynamics", "linearize_flow_map",
             "rbd_velocity_from_centroidal", "full_centroidal_state_from_rbd",
             "fk_unrolled", "frame_velocity", "leg_chain_fk",
             "foot_kinematics", "ee_chain_pose")


def _draw(seed):
    """(q, v, u, tau, Jc-free f_c, v_joints) as float32 numpy."""
    rng = np.random.default_rng(100 + seed)
    q = default_q(base_pos=(0.0, 0.0, 0.38)).astype(np.float32)
    q[:3] += rng.uniform(-0.1, 0.1, 3)
    q[3:6] = rng.uniform(-0.4, 0.4, 3)
    q[6:] += rng.uniform(-0.3, 0.3, 18)
    f32 = np.float32
    return dict(q=q.astype(f32),
                v=(0.5 * rng.standard_normal(24)).astype(f32),
                u=np.concatenate([rng.uniform(-20, 20, 12) + [0, 0, 60] * 4,
                                  rng.uniform(-1, 1, 18)]).astype(f32),
                tau=(10.0 * rng.standard_normal(24)).astype(f32),
                f_c=(rng.uniform(-20, 20, 12) + [0, 0, 60] * 4).astype(f32),
                vj=rng.uniform(-1, 1, 18).astype(f32))


@pytest.fixture(scope="module")
def sides():
    jm, tm = j_load_model(), t_load_model()
    ji, ti = JC.make_centroidal_info(jm), TC.make_centroidal_info(tm)

    def j_x(q, v):
        return JC.centroidal_state_from_rbd(jm, ji, q, v)

    jax_fns = dict(
        forward_dynamics=lambda d: (
            JD.forward_dynamics(jm, d["q"], d["v"], d["tau"]),
            JD.forward_dynamics(jm, d["q"], d["v"], d["tau"],
                                JK.stacked_contact_jacobian(jm, d["q"]),
                                d["f_c"])),
        linearize_flow_map=lambda d: JC.linearize_flow_map(
            jm, ji, j_x(d["q"], d["v"]), d["u"]),
        rbd_velocity_from_centroidal=lambda d: (
            JC.rbd_velocity_from_centroidal(ji, j_x(d["q"], d["v"])),
            JC.rbd_velocity_from_centroidal(ji, j_x(d["q"], d["v"]),
                                            d["vj"])),
        full_centroidal_state_from_rbd=lambda d:
            JC.full_centroidal_state_from_rbd(jm, d["q"], d["v"]),
        fk_unrolled=lambda d: JK.fk_unrolled(jm, d["q"]),
        frame_velocity=lambda d: [JK.frame_velocity(jm, d["q"], d["v"], n)
                                  for n in (EE_FRAME, "LF_FOOT", "base")],
        leg_chain_fk=lambda d: JK.leg_chain_fk(jm, d["q"]),
        foot_kinematics=lambda d: JK.foot_kinematics(jm, d["q"]),
        ee_chain_pose=lambda d: JK.ee_chain_pose(jm, d["q"]))

    def t_x(q, v):
        return TC.centroidal_state_from_rbd(tm, ti, q, v)

    torch_fns = dict(
        forward_dynamics=lambda d: (
            TD.forward_dynamics(tm, d["q"], d["v"], d["tau"]),
            TD.forward_dynamics(tm, d["q"], d["v"], d["tau"],
                                TK.stacked_contact_jacobian(tm, d["q"]),
                                d["f_c"])),
        linearize_flow_map=lambda d: TC.linearize_flow_map(
            tm, ti, t_x(d["q"], d["v"]), d["u"]),
        rbd_velocity_from_centroidal=lambda d: (
            TC.rbd_velocity_from_centroidal(ti, t_x(d["q"], d["v"])),
            TC.rbd_velocity_from_centroidal(ti, t_x(d["q"], d["v"]),
                                            d["vj"])),
        full_centroidal_state_from_rbd=lambda d:
            TC.full_centroidal_state_from_rbd(tm, d["q"], d["v"]),
        fk_unrolled=lambda d: TK.fk_unrolled(tm, d["q"]),
        frame_velocity=lambda d: [TK.frame_velocity(tm, d["q"], d["v"], n)
                                  for n in (EE_FRAME, "LF_FOOT", "base")],
        leg_chain_fk=lambda d: TK.leg_chain_fk(tm, d["q"]),
        foot_kinematics=lambda d: TK.foot_kinematics(tm, d["q"]),
        ee_chain_pose=lambda d: TK.ee_chain_pose(tm, d["q"]))
    return {k: jax.jit(f) for k, f in jax_fns.items()}, torch_fns


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_matches_jax(sides, name, seed):
    jfns, tfns = sides
    d = _draw(seed)
    want = jax.tree_util.tree_leaves(jfns[name]({k: jnp.asarray(a)
                                                 for k, a in d.items()}))
    got = jax.tree_util.tree_leaves(
        tfns[name]({k: torch.as_tensor(a) for k, a in d.items()}),
        is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert len(got) == len(want)
    tol = 1e-4 if name == "forward_dynamics" else 1e-5
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert err.max() <= tol, (name, float(err.max()))


def test_fk_unrolled_equals_fk():
    """The port's two FK formulations agree (as the JAX module's do)."""
    tm = t_load_model()
    q = torch.as_tensor(_draw(0)["q"])
    a, b = TK.fk(tm, q), TK.fk_unrolled(tm, q)
    for k in ("R", "p", "a", "o"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-5)
