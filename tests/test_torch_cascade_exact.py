"""PyTorch port vs JAX reference: the exact-shape WBC cascade
(kernels/cascade_exact.py), the batch path's plain cascade.

The port's `cascade_exact` against JAX's on the same numpy inputs, with
the bounds and the per-level residual rule of
tests/test_torch_kernel_hoqp.py (each just above the gap it measured):
  * random cascades: as drawn (infeasible at level 0, degenerate below)
    on the per-level objectives, 0.2 max(|o|, 1) + 0.6; with feasible
    bounds (f + 10) x itself within 2e-4 (1 + |x|inf) plus the gap
    between the JAX package's own two cascades on the same input
    (cascade_exact against fused_hoqp_reference: up to 5.1e-4 of
    1 + |x|inf at seed 2, where the port lands 3.6e-4 from JAX's
    cascade_exact and 1.5e-4 from its reference). On these inputs the
    port's cascade_exact and cascade_plain agree bit for bit;
  * stance stack: torques within 0.1 Nm; trot stack: 2.0 Nm plus the
    per-level residual criterion;
  * warm starts as the cold stacks.
Beside them the JAX package's own properties of the cascade
(tests/test_kernels.py): a warm start with validity 0 is the cold solve
bit for bit; a warm start at 10 iterations stays at the 20-iteration cold
optimum (0.25 max(|o|, 1) + 0.6). `vmap` over B = 3 real stacks holds
each scenario to the per-scenario call on the per-level objectives
(0.2 max(|o|, 1) + 0.6), the residual criterion and the torques: trot
2.0 Nm, stance 0.2 Nm. The batched products sum in another order, and
the stance optimum is flat: vmap lands 0.155 Nm from the single call
(cold and warm; the level-0 and level-1 residuals agree to 6e-4, level
2's to 0.04 of 22.8), and 1e-7 input
dust moves the stance optimum up to 0.179 Nm on the H100 (PERF.md).
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_control_tpu.kernels import cascade_exact as JCE
from qm_control_tpu.kernels.hoqp_fused import fused_hoqp_reference
from test_torch_kernel_hoqp import (_jax, _objectives, _random_cascade,
                                    _residuals_ok, _torch, _torques,
                                    stacks)  # noqa: F401  (fixture)

from qm_control_tpu_torch.interop import (exact_warm_from_numpy,
                                          exact_warm_to_numpy)
from qm_control_tpu_torch.kernels import cascade_exact as CE
from qm_control_tpu_torch.kernels import hoqp_fused as K
from qm_control_tpu_torch.wbc.tasks import Task as TTask

torch.set_num_threads(1)

_jcascade = jax.jit(JCE.cascade_exact,
                    static_argnames=("qp_iters", "return_warm"))
TOL = {"stance": 0.1, "trot": 2.0}
VMAP_TOL = {"stance": 0.2, "trot": 2.0}


def _nudged(stack, rel=1e-3):
    return [tuple(np.asarray(a * (1.0 + rel), np.float32) for a in t)
            for t in stack]


@pytest.mark.parametrize("seed", range(6))
def test_random_cascades_match_jax(seed):
    stack = _random_cascade(np.random.default_rng(seed))
    xj = np.asarray(_jcascade(*_jax(stack)))
    xt = CE.cascade_exact(*_torch(stack)).numpy()
    assert np.isfinite(xt).all()
    oj, ot = _objectives(stack, xj), _objectives(stack, xt)
    assert (np.abs(ot - oj) <= 0.2 * np.maximum(np.abs(oj), 1.0) + 0.6).all(), (
        oj, ot)
    feasible = _random_cascade(np.random.default_rng(seed), f_shift=10.0)
    xj = np.asarray(_jcascade(*_jax(feasible)))
    jax_gap = np.abs(np.asarray(fused_hoqp_reference(*_jax(feasible)))
                     - xj).max()
    xt = CE.cascade_exact(*_torch(feasible))
    assert torch.equal(xt, K.cascade_plain(*_torch(feasible)))
    assert np.abs(xt.numpy() - xj).max() <= (
        2e-4 * (1.0 + np.abs(xj).max()) + jax_gap)


def _check_real(name, m_, stack, xt, xj, tol=TOL):
    assert np.isfinite(xt).all()
    err = np.abs(_torques(m_, xt) - _torques(m_, xj)).max()
    assert err < tol[name], err
    if name == "trot":
        assert _residuals_ok(stack, xt.astype(np.float64),
                             xj.astype(np.float64))


def _check_batched(name, m_, stack, xb, x1):
    """One scenario of a vmapped call against the single call."""
    _check_real(name, m_, stack, xb, x1, VMAP_TOL)
    assert _residuals_ok(stack, xb.astype(np.float64), x1.astype(np.float64))
    ob, o1 = _objectives(stack, xb), _objectives(stack, x1)
    assert (np.abs(ob - o1) <= 0.2 * np.maximum(np.abs(o1), 1.0) + 0.6).all()


@pytest.mark.parametrize("name", ["stance", "trot"])
def test_real_stacks_match_jax(stacks, name):
    m_, stack = stacks[name]
    xj = np.asarray(_jcascade(*_jax(stack)))
    xt = CE.cascade_exact(*_torch(stack)).numpy()
    _check_real(name, m_, stack, xt, xj)


@pytest.mark.parametrize("name", ["stance", "trot"])
def test_warm_matches_jax(stacks, name):
    """Warm start from JAX's ExactWarm of the neighbouring solve (handed
    over through interop.exact_warm_from_numpy) on a nudged stack."""
    m_, stack = stacks[name]
    _, wj = _jcascade(*_jax(stack), return_warm=True)
    nudged = _nudged(stack)
    xj, wj2 = _jcascade(*_jax(nudged), warm=wj, return_warm=True)
    wt = exact_warm_from_numpy([np.asarray(a) for a in wj], device="cpu")
    xt, wt2 = CE.cascade_exact(*_torch(nudged), warm=wt, return_warm=True)
    _check_real(name, m_, nudged, xt.numpy(), np.asarray(xj))
    assert float(wt2.valid) == float(wj2.valid) == 1.0
    assert [a.shape for a in exact_warm_to_numpy(wt2)] == [
        np.asarray(a).shape for a in wj2]


def test_warm_invalid_is_cold_bit_exact(stacks):
    _, stack = stacks["stance"]
    xc = CE.cascade_exact(*_torch(stack), qp_iters=12)
    xw = CE.cascade_exact(*_torch(stack), qp_iters=12,
                          warm=CE.zero_warm(56, device="cpu"))
    assert torch.equal(xc, xw)


def _port_stack(tm, ti, flags, vq):
    """A stack of tests/test_kernels.py:wbc_stacks (contact flags, joint
    velocity vq) built by the port, as numpy."""
    from qm_control_tpu_torch.models import default_q
    from qm_control_tpu_torch.wbc import tasks as T
    x = torch.zeros(30)
    x[6:30] = torch.as_tensor(default_q(base_pos=(0, 0, 0.4)),
                              dtype=torch.float32)
    z30 = torch.zeros(30)
    m_, d_ = T.compute_wbc_data(tm, ti, x, z30, z30, x[6:30],
                                torch.full((24,), vq),
                                torch.tensor(flags),
                                torch.tensor(0.002))
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    t0 = (T.floating_base_eom_task(m_) + T.torque_limits_task(m_, tau_max)
          + T.no_contact_motion_task(m_) + T.friction_cone_task(m_, 0.5))
    t1 = (T.base_height_task(m_, d_, 100., 10.)
          + T.base_angular_task(m_, d_, 100., 10.)
          + T.ee_linear_task(m_, d_, 100., 10.)
          + T.ee_angular_task(m_, d_, 100., 10.)
          + T.swing_leg_task(m_, d_, 100., 10.).scaled(100.))
    t2 = T.contact_force_task(m_, z30) + T.base_linear_task(m_, d_, 100.,
                                                            10.)
    return [tuple(a.numpy() for a in t) for t in (t0, t1, t2)]


def test_warm_start_stays_optimal():
    """tests/test_kernels.py:test_cascade_exact_warm_start_stays_optimal
    on the port: a warm carry from a neighbouring state (joint velocity
    +1e-3) at 10 iterations lands at the 20-iteration cold optimum."""
    from qm_control_tpu_torch.models import centroidal as TC
    from qm_control_tpu_torch.models import load_model
    tm = load_model()
    ti = TC.make_centroidal_info(tm)
    trot = (1., 0., 0., 1.)
    st_a, st_b = (_port_stack(tm, ti, trot, 0.05),
                  _port_stack(tm, ti, trot, 0.051))
    _, w = CE.cascade_exact(*_torch(st_a), qp_iters=20, return_warm=True)
    o_cold = _objectives(st_b, CE.cascade_exact(*_torch(st_b),
                                                qp_iters=20).numpy())
    o_warm = _objectives(st_b, CE.cascade_exact(*_torch(st_b), qp_iters=10,
                                                warm=w).numpy())
    scale = np.maximum(np.abs(o_cold), 1.0)
    assert (o_warm - o_cold <= 0.25 * scale + 0.6).all(), (o_cold, o_warm)


def test_warm_buffer_roundtrip():
    """ExactWarm <-> K1's (9, W) buffer: the same nine rows; the buffer's
    lanes past each row's length are zero, row 0 the validity."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((9, 56)).astype(np.float32)
    w[0] = 1.0
    w[[1, 5, 7], 36:] = 0.0
    ew = CE.warm_from_buffer(torch.from_numpy(w))
    assert float(ew.valid) == 1.0 and ew.z1.shape == (36,)
    assert ew.lam2.shape == (56,)
    np.testing.assert_array_equal(CE.warm_to_buffer(ew).numpy(), w)
    back = CE.warm_from_buffer(CE.warm_to_buffer(ew))
    assert all(torch.equal(a, b) for a, b in zip(back, ew))
    # the plain cascade's warm_out, read as an ExactWarm, warms
    # cascade_exact exactly as the same rows handed over as fields
    _, buf = K.cascade_plain(*_torch(_random_cascade(
        np.random.default_rng(1), f_shift=10.0)), return_warm=True)
    assert torch.equal(CE.warm_to_buffer(CE.warm_from_buffer(buf)), buf)


def _batched(stack_list):
    return [TTask(*[torch.stack([torch.tensor(np.asarray(s[lvl][k]))
                                 for s in stack_list]) for k in range(4)])
            for lvl in range(3)]


def test_vmap_matches_per_scenario(stacks):
    """B = 3 real stacks (stance, trot, trot nudged) under vmap, cold and
    warm, against one call per scenario; fused_hoqp_batched on CPU
    tensors is the same vmap."""
    names = ["stance", "trot", "trot"]
    stack_list = [stacks["stance"][1], stacks["trot"][1],
                  _nudged(stacks["trot"][1])]
    bt = _batched(stack_list)
    xb, wb = vmap(lambda a, b, c: CE.cascade_exact(
        a, b, c, return_warm=True))(*bt)
    xk, bufk = K.fused_hoqp_batched(*bt, return_warm=True)
    assert torch.equal(xk, xb)
    assert torch.equal(bufk, CE.warm_to_buffer(wb))
    xbw = vmap(lambda a, b, c, w: CE.cascade_exact(a, b, c, warm=w))(
        *_batched([_nudged(s) for s in stack_list]), wb)
    assert torch.equal(K.fused_hoqp_batched(
        *_batched([_nudged(s) for s in stack_list]), warm=bufk), xbw)
    for i, (name, stack) in enumerate(zip(names, stack_list)):
        m_ = stacks[name][0]
        x1, w1 = CE.cascade_exact(*_torch(stack), return_warm=True)
        _check_batched(name, m_, stack, xb[i].numpy(), x1.numpy())
        nudged = _nudged(stack)
        xw1 = CE.cascade_exact(*_torch(nudged), warm=w1)
        _check_batched(name, m_, nudged, xbw[i].numpy(), xw1.numpy())
