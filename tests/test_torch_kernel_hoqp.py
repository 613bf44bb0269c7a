"""PyTorch port vs JAX reference: K1, the fused WBC cascade.

The port's `cascade_plain` (what CPU tensors run, and what the CUDA kernel
is held against on the card) against JAX `fused_hoqp_reference` (the math
of the Pallas kernel; `test_pallas_call_packaging_interpret` pins it to
the interpret-mode pallas_call) on the same numpy inputs.

Tolerances (each just above the gap measured on the CPU, noted beside it):
  * random cascades (the draws of tests/test_kernels.py:_random_cascade):
    as drawn they are infeasible at level 0 and degenerate below, so two
    f32 implementations land up to ~0.5 apart in x (JAX's own padded and
    exact-shape paths: up to 0.54). They are held on the per-level
    objectives; with feasible bounds (f + 10) on x, 2e-4 (1 + |x|inf)
    (measured up to 1.53e-4, seed 2; 1e-7 input dust alone moves the plain
    version ~1.7e-4 of 1 + |x|).
  * stance stack: torques within 0.1 Nm (measured 0.019 Nm cold,
    0.006 Nm warm).
  * trot stack: torques within 2.0 Nm (measured 0.040 Nm cold, 0.004 Nm
    warm; the trot optimum wanders +-0.7 Nm under last-bit input dust,
    tests/test_kernels.py:185-193) plus the per-level residual criterion
    of test_cascade_vs_f64_referee.
  * warm variant against JAX with the same warm buffer: as the cold
    stacks; validity 0 equals the cold solve bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.kernels.hoqp_fused import fused_hoqp_reference
from qm_control_tpu.wbc import tasks as JT
from qm_control_tpu.wbc.tasks import Task as JTask

from qm_control_tpu_torch.interop import warm_from_jax, warm_to_jax
from qm_control_tpu_torch.kernels import hoqp_fused as K
from qm_control_tpu_torch.wbc.tasks import Task as TTask

torch.set_num_threads(1)


def _random_cascade(rng, nx=36, nv=56, f_shift=0.0):
    """Same draws as tests/test_kernels.py:_random_cascade (numpy)."""
    A0 = rng.standard_normal((30, nx)).astype(np.float32) * 0.5
    b0 = rng.standard_normal(30).astype(np.float32)
    D = rng.standard_normal((nv, nx)).astype(np.float32) * 0.3
    f = rng.standard_normal(nv).astype(np.float32) * 0.5 + 2.0 + f_shift
    A1 = rng.standard_normal((22, nx)).astype(np.float32) * 0.5
    b1 = rng.standard_normal(22).astype(np.float32)
    A2 = rng.standard_normal((14, nx)).astype(np.float32) * 0.5
    b2 = rng.standard_normal(14).astype(np.float32)
    e, ev = np.zeros((0, nx), np.float32), np.zeros(0, np.float32)
    return [(A0, b0, D, f.astype(np.float32)), (A1, b1, e, ev),
            (A2, b2, e, ev)]


def _jax(stack):
    return [JTask(*map(jnp.asarray, t)) for t in stack]


def _torch(stack):
    return [TTask(*[torch.from_numpy(np.array(a, np.float32)) for a in t])
            for t in stack]


def _objectives(stack, x):
    """Per-level residual norms and the worst level-0 violation."""
    A0, _b0, D, f = stack[0]
    return np.array([np.linalg.norm(A @ x - b) for A, b, _, _ in stack]
                    + [np.max(D @ x - f)])


@pytest.mark.parametrize("seed", range(6))
def test_random_cascades_match_jax(seed):
    """As drawn, the level-0 inequalities are infeasible (the slack
    absorbs them) and the lower levels degenerate: x is held on the
    per-level objectives with the bound of the repo's own
    two-implementation test (test_cascade_exact_matches_padded_objectives).
    With the bounds loosened by 10 the cascade is well-posed and x itself
    is held within 2e-4 (1 + |x|inf) (measured up to 1.53e-4)."""
    stack = _random_cascade(np.random.default_rng(seed))
    xj = np.asarray(fused_hoqp_reference(*_jax(stack)))
    xt = K.cascade_plain(*_torch(stack)).numpy()
    assert np.isfinite(xt).all()
    oj, ot = _objectives(stack, xj), _objectives(stack, xt)
    assert (np.abs(ot - oj) <= 0.2 * np.maximum(np.abs(oj), 1.0) + 0.6).all(), (
        oj, ot)
    feasible = _random_cascade(np.random.default_rng(seed), f_shift=10.0)
    xj = np.asarray(fused_hoqp_reference(*_jax(feasible)))
    xt = K.cascade_plain(*_torch(feasible)).numpy()
    assert np.abs(xt - xj).max() <= 2e-4 * (1.0 + np.abs(xj).max())


@pytest.fixture(scope="module")
def stacks():
    """The real stance and trot stacks of tests/test_kernels.py:92-121,
    built by the JAX package, as numpy."""
    from qm_control_tpu.models import centroidal as C
    from qm_control_tpu.models import load_model
    from qm_control_tpu.models.spec import default_q
    model = load_model()
    info = C.make_centroidal_info(model)
    x = np.zeros(30, dtype=np.float32)
    x[6:30] = default_q(base_pos=(0, 0, 0.4))
    x = jnp.asarray(x)
    tau_max = jnp.asarray(model.joint_effort, dtype=jnp.float32)

    def build(flags, vq):
        m_, d_ = JT.compute_wbc_data(model, info, x, jnp.zeros(30),
                                     jnp.zeros(30), x[6:30], vq, flags,
                                     jnp.asarray(0.002, jnp.float32))
        t0 = (JT.floating_base_eom_task(m_)
              + JT.torque_limits_task(m_, tau_max)
              + JT.no_contact_motion_task(m_)
              + JT.friction_cone_task(m_, 0.5))
        t1 = (JT.base_height_task(m_, d_, 100., 10.)
              + JT.base_angular_task(m_, d_, 100., 10.)
              + JT.ee_linear_task(m_, d_, 100., 10.)
              + JT.ee_angular_task(m_, d_, 100., 10.)
              + JT.swing_leg_task(m_, d_, 100., 10.).scaled(100.))
        t2 = (JT.contact_force_task(m_, jnp.zeros(30))
              + JT.base_linear_task(m_, d_, 100., 10.))
        return m_, [tuple(np.asarray(a) for a in t) for t in (t0, t1, t2)]

    return {"stance": build(jnp.ones(4), jnp.zeros(24)),
            "trot": build(jnp.asarray([1., 0., 0., 1.]),
                          0.05 * jnp.ones(24))}


def _torques(m_, x):
    return np.asarray(JT.recover_torques(m_, jnp.asarray(x, jnp.float32)))


def _residuals_ok(stack, x_port, x_ref):
    for A, b, _D, _f in stack:
        r_port = np.linalg.norm(A @ x_port - b)
        r_ref = np.linalg.norm(A @ x_ref - b)
        if not r_port < 1.25 * r_ref + 0.005 * (1.0 + np.linalg.norm(b)):
            return False
    return True


@pytest.mark.parametrize("name,tol", [("stance", 0.1), ("trot", 2.0)])
def test_real_stacks_match_jax(stacks, name, tol):
    m_, stack = stacks[name]
    xj = np.asarray(fused_hoqp_reference(*_jax(stack)))
    xt = K.cascade_plain(*_torch(stack)).numpy()
    assert np.isfinite(xt).all()
    err = np.abs(_torques(m_, xt) - _torques(m_, xj)).max()
    assert err < tol, err
    if name == "trot":
        assert _residuals_ok(stack, xt.astype(np.float64),
                             xj.astype(np.float64))


@pytest.mark.parametrize("name,tol", [("stance", 0.1), ("trot", 2.0)])
def test_warm_variant_matches_jax(stacks, name, tol):
    """Warm start from the previous solve's warm buffer (converted with
    interop.warm_from_jax) on a neighbouring stack."""
    m_, stack = stacks[name]
    _, wj = fused_hoqp_reference(*_jax(stack), return_warm=True)
    wj = np.asarray(wj)
    nudged = [tuple(np.asarray(a * (1.0 + 1e-3), np.float32) for a in t)
              for t in stack]
    xj, wj2 = fused_hoqp_reference(*_jax(nudged), warm=jnp.asarray(wj),
                                   return_warm=True)
    xt, wt2 = K.cascade_plain(*_torch(nudged), warm=warm_from_jax(
        wj, nv=56, device="cpu"), return_warm=True)
    xj, xt = np.asarray(xj), xt.numpy()
    err = np.abs(_torques(m_, xt) - _torques(m_, xj)).max()
    assert err < tol, err
    assert wt2.shape == (9, 56)
    np.testing.assert_array_equal(wt2[0].numpy(), np.ones(56, np.float32))


def test_warm_invalid_is_cold_bit_exact(stacks):
    _, stack = stacks["stance"]
    xc = K.cascade_plain(*_torch(stack), qp_iters=12)
    xw = K.cascade_plain(*_torch(stack), qp_iters=12,
                         warm=K.zero_warm(56, device="cpu"))
    assert torch.equal(xc, xw)


def test_warm_layout_roundtrip():
    """warm_to_jax then warm_from_jax is the identity on the active lanes
    (z rows: 36 lanes, slack/dual rows: 56 lanes)."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((9, 56)).astype(np.float32)
    w[0] = 1.0
    w[[1, 5, 7], 36:] = 0.0
    wj = warm_to_jax(torch.from_numpy(w))
    assert wj.shape == (9, 128)
    np.testing.assert_array_equal(wj[0], np.ones(128, np.float32))
    back = warm_from_jax(wj, nv=56, device="cpu")
    np.testing.assert_array_equal(back.numpy(), w)


def test_wrapper_runs_plain_on_cpu(stacks):
    _, stack = stacks["stance"]
    before = K.launch_count
    x = K.fused_hoqp(*_torch(stack))
    assert torch.equal(x, K.cascade_plain(*_torch(stack)))
    assert K.launch_count == before
