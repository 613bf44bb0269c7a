"""PyTorch port vs JAX reference: the pivoted WBC cascade (wbc/qp.py,
wbc/hoqp.py) and the QR kernel basis (kernels/hoqp_fused.py).

The same numpy inputs go through the JAX functions and the port's.
Tolerances (each above the gap measured on the CPU, noted beside it):
  * _pd_inverse against numpy's float64 inverse at tests/test_kernels.py's
    bound (1e-4 max|inv| + 1e-5) and against JAX's within 1e-5 max|inv|
    (measured 4.1e-6 at n = 20, |inv| ~ 1);
  * solve_qp on tests/test_qp.py's cases at that file's bounds, and x
    against JAX within 1e-3 (1 + |x|inf) (measured 6e-5 of 3.3);
  * the damped projector against JAX within 1e-6 (measured 1e-7); the QR
    kernel basis through its projector K K' within 1e-5 and the residual
    |Az K| within 1e-5 |Az| (the basis is unique only up to a rotation
    inside ker(Az); measured 6e-7 and 5e-7);
  * hoqp_solve on tests/test_qp.py's toys at that file's bounds and
    against JAX within 1e-3 (1 + |x|inf) (measured 4.5e-5);
  * hoqp_solve on the real stance and trot stacks (the main stack and the
    MPC-only variant's, built by the JAX package) against JAX's: torques
    within tests/test_torch_kernel_hoqp.py's 0.1 Nm (stance) and 2.0 Nm
    (trot) (measured 0.0010 / 0.0091 Nm main, 0.0002 / 0.0045 Nm
    MPC-only), every level by that file's residual criterion, and the
    per-level objectives within 0.2 max(|o|, 1) + 0.6 (the bound of the
    repo's two-implementation test); the same with USE_QR_BASIS in both
    packages (measured 0.0013 / 0.0021 Nm).

JAX's cascade runs in float64 here (_jax64), the precision of the port's
level QPs (wbc/hoqp.py QP_DTYPE). In float32 its interior point diverges
on stance stacks, past the reach of a comparison: 0.68 Nm from the port
on the MPC-only stance stack (the float64 cascades agree to 0.0002 Nm),
0.45-0.62 Nm on the main one, 0.27 Nm with the QR basis, and 6.7e-3 on
the inequality toy against a 3.0e-3 bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.kernels.hoqp_fused import _eye, _kernel_basis_qr as j_qr
from qm_control_tpu.wbc import hoqp as JH
from qm_control_tpu.wbc import tasks as JT
from qm_control_tpu.wbc.qp import _pd_inverse as j_pd_inverse
from qm_control_tpu.wbc.qp import solve_qp as j_solve_qp
from qm_control_tpu.wbc.tasks import Task as JTask
from test_torch_kernel_hoqp import (_objectives, _residuals_ok, _torch,
                                    _torques)

from qm_control_tpu_torch.kernels.hoqp_fused import _kernel_basis_qr
from qm_control_tpu_torch.wbc import hoqp as TH
from qm_control_tpu_torch.wbc.qp import _pd_inverse, solve_eq_qp, solve_qp
from qm_control_tpu_torch.wbc.tasks import NUM_DECISION_VARS

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("n", [8, 24, 36])
def test_pd_inverse_matches_numpy_and_jax(n):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)).astype(np.float32)
    spd = A @ A.T + n * np.eye(n, dtype=np.float32)
    out = _pd_inverse(_t(spd)).numpy()
    ref = np.linalg.inv(spd.astype(np.float64))
    assert np.abs(out - ref).max() < 1e-4 * np.abs(ref).max() + 1e-5
    jout = np.asarray(j_pd_inverse(jnp.asarray(spd)))
    assert np.abs(out - jout).max() <= 1e-5 * np.abs(jout).max()


def test_pd_inverse_near_singular_no_nan():
    """The pivot floor: eigenvalues at 1e-6 give no inf/NaN (the case of
    tests/test_kernels.py:test_gj_inverse_near_singular_no_nan)."""
    rng = np.random.default_rng(4)
    U = np.linalg.qr(rng.standard_normal((36, 36)))[0].astype(np.float32)
    eigs = np.ones(36, np.float32)
    eigs[20:] = 1e-6
    assert torch.isfinite(_pd_inverse(_t((U * eigs) @ U.T))).all()


def _random_qp(rng, n=20, m=30):
    """tests/test_qp.py:_random_qp."""
    A = rng.standard_normal((n, n))
    H = A @ A.T + 0.1 * np.eye(n)
    c = rng.standard_normal(n)
    G = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.uniform(0.1, 1.0, m)
    return [np.asarray(a, np.float32) for a in (H, c, G, h)]


def _both_qp(qp, **kw):
    tsol = solve_qp(*map(_t, qp), **kw)
    jsol = j_solve_qp(*map(jnp.asarray, qp), **kw)
    return tsol, jsol


def test_qp_kkt_residuals_and_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        H, c, G, h = qp = _random_qp(rng)
        sol, jsol = _both_qp(qp, num_iters=30)
        x, lam = sol.x.numpy(), sol.lam.numpy()
        scale = max(1.0, float(np.linalg.norm(c)))
        # tests/test_qp.py's bounds
        assert np.linalg.norm(H @ x + c + G.T @ lam) / scale < 2e-2
        assert (G @ x - h).max() < 1e-4 * scale
        assert float(sol.gap) < 1e-3
        assert (lam >= -1e-6).all()
        xj = np.asarray(jsol.x)
        assert np.abs(x - xj).max() <= 1e-3 * (1.0 + np.abs(xj).max())


def test_qp_inactive_and_active_bound():
    rng = np.random.default_rng(0)
    H, c, G, h = _random_qp(rng, n=10, m=5)
    sol, jsol = _both_qp((H, c, G, h + 100.0), num_iters=30)
    x_ref = np.linalg.solve(H.astype(np.float64), -c.astype(np.float64))
    np.testing.assert_allclose(sol.x.numpy(), x_ref, atol=1e-3)
    np.testing.assert_allclose(solve_eq_qp(_t(H), _t(c)).numpy(), x_ref,
                               atol=1e-3)
    # min 0.5 x'x - 10 x0 s.t. x0 <= 2 -> x0 = 2
    n = 4
    c = np.zeros(n, np.float32)
    c[0] = -10.0
    G = np.zeros((1, n), np.float32)
    G[0, 0] = 1.0
    sol, jsol = _both_qp((np.eye(n, dtype=np.float32), c, G,
                          np.float32([2.0])), num_iters=30)
    np.testing.assert_allclose(sol.x.numpy(), [2.0, 0, 0, 0], atol=1e-3)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), atol=1e-3)


def _az(seed):
    """A (10, 36) task matrix with two masked (exact zero) rows."""
    Az = np.random.default_rng(seed).standard_normal((10, 36)).astype(
        np.float32)
    Az[[3, 7]] = 0.0
    return Az


@pytest.mark.parametrize("seed", range(3))
def test_kernel_projector_and_qr_basis_match_jax(seed):
    Az = _az(seed)
    P = TH._kernel_projector(_t(Az)).numpy()
    np.testing.assert_allclose(P, np.asarray(JH._kernel_projector(
        jnp.asarray(Az))), atol=1e-6)
    # the QR basis: the port's exact-shape function and JAX's padded one
    Kt = _kernel_basis_qr(_t(Az)).numpy()
    Azp = jnp.zeros((128, 128), jnp.float32).at[:10, :36].set(Az)
    Kj = np.asarray(j_qr(Azp, 10, _eye(), 36))[:36, :36]
    assert np.abs(Kt @ Kt.T - Kj @ Kj.T).max() <= 1e-5
    assert np.abs(Az @ Kt).max() <= 1e-5 * np.abs(Az).max()
    # rank 8: 28 orthonormal kernel columns, the others exact zeros
    assert (np.abs(Kt).sum(0) > 0).sum() == 28
    np.testing.assert_allclose(Kt.T @ Kt, np.diag((np.abs(Kt).sum(0) > 0)
                                                  .astype(np.float32)),
                               atol=1e-5)
    np.testing.assert_array_equal(TH._kernel_basis(_t(Az)).numpy(), Kt)


def _task(A=None, b=None, D=None, f=None):
    """tests/test_qp.py:_task, as numpy (rows, b) pairs."""
    n = NUM_DECISION_VARS
    z, v0 = np.zeros((0, n), np.float32), np.zeros((0,), np.float32)

    def mk(M):
        return np.asarray(np.atleast_2d(M), np.float32)

    def vk(x):
        return np.asarray(np.atleast_1d(x), np.float32)
    return (mk(A) if A is not None else z, vk(b) if b is not None else v0,
            mk(D) if D is not None else z, vk(f) if f is not None else v0)


def _toy(kind):
    """The three cascades of tests/test_qp.py and the x they must reach."""
    n = NUM_DECISION_VARS
    A0 = np.zeros((1, n))
    A0[0, 0] = 1
    if kind != "slack":
        A0[0, 1] = 1
    k = 1 if kind == "slack" else 2
    A_pin = np.zeros((n - k, n))
    A_pin[:, k:] = np.eye(n - k)
    b0 = np.concatenate([[3.0 if kind == "slack" else 1.0], np.zeros(n - k)])
    D0 = np.zeros((1, n))
    D0[0, 0] = 1
    t0 = (_task(A=np.vstack([A0, A_pin]), b=b0, D=D0, f=[2.0])
          if kind == "inequality" else _task(A=np.vstack([A0, A_pin]), b=b0))
    A1 = np.zeros((1, n))
    A1[0, 0] = 1
    t1 = _task(A=A1, b=[-5.0 if kind == "slack" else 10.0])
    want = {"lexicographic": ([10.0, -9.0], 1e-2),
            "inequality": ([2.0, -1.0], 2e-2),
            "slack": ([3.0], 1e-3)}[kind]
    return [t0, t1], want


def _jax64(stack):
    """JAX's pivoted cascade on the stack in float64 (USE_QR_BASIS read at
    the call)."""
    with jax.enable_x64(True):
        return np.asarray(JH.hoqp_solve([JTask(*[
            jnp.asarray(np.asarray(a, np.float64)) for a in t])
            for t in stack]))


@pytest.mark.parametrize("kind", ["lexicographic", "inequality", "slack"])
def test_hoqp_toys(kind):
    stack, (head, atol) = _toy(kind)
    x = TH.hoqp_solve(_torch(stack)).numpy()
    np.testing.assert_allclose(x[:len(head)], head, atol=atol)
    if kind == "lexicographic":
        np.testing.assert_allclose(x[2:], 0.0, atol=1e-3)
    xj = _jax64(stack)
    assert np.abs(x - xj).max() <= 1e-3 * (1.0 + np.abs(xj).max())


def _stack(model, info, flags, vq, mpc_only):
    """The real stacks of tests/test_torch_kernel_hoqp.py, main or
    MPC-only (t1 = height, angular, linear, swing; t2 = contact force),
    built by the JAX package."""
    from qm_control_tpu.models.spec import default_q
    x = np.zeros(30, dtype=np.float32)
    x[6:30] = default_q(base_pos=(0, 0, 0.4))
    x = jnp.asarray(x)
    m_, d_ = JT.compute_wbc_data(model, info, x, jnp.zeros(30), jnp.zeros(30),
                                 x[6:30], vq, flags,
                                 jnp.asarray(0.002, jnp.float32))
    t0 = (JT.floating_base_eom_task(m_)
          + JT.torque_limits_task(m_, jnp.asarray(model.joint_effort,
                                                  jnp.float32))
          + JT.no_contact_motion_task(m_) + JT.friction_cone_task(m_, 0.5))
    height = JT.base_height_task(m_, d_, 100., 10.)
    angular = JT.base_angular_task(m_, d_, 100., 10.)
    linear = JT.base_linear_task(m_, d_, 100., 10.)
    swing = JT.swing_leg_task(m_, d_, 100., 10.).scaled(100.)
    force = JT.contact_force_task(m_, jnp.zeros(30))
    if mpc_only:
        t1, t2 = height + angular + linear + swing, force
    else:
        t1 = (height + angular + JT.ee_linear_task(m_, d_, 100., 10.)
              + JT.ee_angular_task(m_, d_, 100., 10.) + swing)
        t2 = force + linear
    return m_, [tuple(np.asarray(a) for a in t) for t in (t0, t1, t2)]


@pytest.fixture(scope="module")
def real_stacks():
    from qm_control_tpu.models import centroidal as C
    from qm_control_tpu.models import load_model
    model = load_model()
    info = C.make_centroidal_info(model)
    cases = {"stance": (jnp.ones(4), jnp.zeros(24)),
             "trot": (jnp.asarray([1., 0., 0., 1.]), 0.05 * jnp.ones(24))}
    return {(name, mpc): _stack(model, info, *cases[name], mpc)
            for name in cases for mpc in (False, True)}


def _hold(m_, stack, xt, xj, tol):
    xt64, xj64 = xt.astype(np.float64), xj.astype(np.float64)
    s64 = [tuple(a.astype(np.float64) for a in t) for t in stack]
    err = np.abs(_torques(m_, xt) - _torques(m_, xj)).max()
    assert np.isfinite(xt).all() and err < tol, err
    assert _residuals_ok(s64, xt64, xj64)
    ot, oj = _objectives(s64, xt64), _objectives(s64, xj64)
    assert (np.abs(ot - oj) <= 0.2 * np.maximum(np.abs(oj), 1.0) + 0.6).all()


@pytest.mark.parametrize("name,tol", [("stance", 0.1), ("trot", 2.0)])
@pytest.mark.parametrize("mpc_only", [False, True], ids=["main", "mpc"])
def test_hoqp_real_stacks_match_jax(real_stacks, name, tol, mpc_only):
    m_, stack = real_stacks[(name, mpc_only)]
    xt = TH.hoqp_solve(_torch(stack)).numpy()
    _hold(m_, stack, xt, _jax64(stack), tol)


@pytest.mark.parametrize("name,tol", [("stance", 0.1), ("trot", 2.0)])
def test_hoqp_qr_basis_matches_jax(real_stacks, monkeypatch, name, tol):
    """USE_QR_BASIS in both packages: the exact-zero kernel basis."""
    m_, stack = real_stacks[(name, False)]
    monkeypatch.setattr(TH, "USE_QR_BASIS", True)
    monkeypatch.setattr(JH, "USE_QR_BASIS", True)
    xt = TH.hoqp_solve(_torch(stack)).numpy()
    _hold(m_, stack, xt, _jax64(stack), tol)
