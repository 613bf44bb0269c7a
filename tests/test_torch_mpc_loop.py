"""PyTorch port vs JAX reference: the QMMpcController variant — the
MPC-only WBC (wbc.hierarchical_mpc_wbc_update), its closed-loop cycle
(runtime/mpc_loop.py: make_mpc_cycle, MpcControlLoop) and
experiments.mpc_variant_standing.

Tolerances:
  * the MPC-only stack (30/56, 18, 12 rows) against the one the JAX
    package builds: rtol 1e-4 / atol 1e-3 (tests/test_torch_wbc.py's);
  * the update with the pivoted cascade (the JAX default) against JAX's:
    every level by tests/test_torch_kernel_hoqp.py's residual criterion,
    the per-level objectives within twice JAX's own move under 1e-7 dust
    on the stack (four draws) plus 0.2 max(|o|, 1) + 0.6, and the torques
    within twice JAX's own torque move plus 0.1 Nm; with
    fused_cascade=True it is K1 (its plain version on CPU tensors), bit
    for bit;
  * two make_mpc_cycle periods (horizon 0.3 s / 0.03 s, 1 SQP iteration,
    LoopConfig(): 500 Hz ticks, 5 per period) from the same carry as the
    JAX cycle: every output within twice the JAX cycle's own spread under
    1e-7 dust on q0 (two draws) plus tests/test_torch_loop.py's floors
    (the 0.38 m spawn's landing transient amplifies last bits ~2x per
    tick); the fresh solve's cost and alpha as tests/test_torch_mpc.py
    holds them;
  * a cut mpc_variant_standing (20 Hz MPC so a chunk is 5 periods, 2
    warm-up solves, 0.05 s) on the CPU: finite, safe, within the JAX
    test's absolute bounds (tests/test_mpc_loop.py: base height 60 mm, arm
    0.2 rad, EE 120 mm). The JAX test's full run is mirrored by the
    slow-marked test below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.config import WbcGains as JGains
from qm_control_tpu.models import centroidal as JC
from qm_control_tpu.models import load_model as j_load_model
from qm_control_tpu.models.spec import default_q
from qm_control_tpu.wbc import tasks as JT
from qm_control_tpu.wbc.hoqp import hoqp_solve as j_hoqp
from test_torch_kernel_hoqp import _objectives, _residuals_ok
from test_torch_loop import _leaves

from qm_control_tpu_torch.config import WbcGains as TGains
from qm_control_tpu_torch.interop import (cycle_carry_from_numpy,
                                          mode_schedule_from_numpy,
                                          target_from_numpy)
from qm_control_tpu_torch.kernels import hoqp_fused as K
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as t_load_model
from qm_control_tpu_torch.runtime.mpc_loop import (MpcCycleCarry,
                                                   make_mpc_cycle)
from qm_control_tpu_torch.wbc.hoqp import hoqp_solve
from qm_control_tpu_torch.wbc.tasks import recover_torques
from qm_control_tpu_torch.wbc.wbc import (hierarchical_mpc_wbc_update,
                                          mpc_wbc_stack)

torch.set_num_threads(1)

_J_CASCADE = jax.jit(lambda ts: j_hoqp(ts))
CASES = {"stance": (np.ones(4, np.float32), np.zeros(24, np.float32)),
         "trot": (np.array([1., 0., 0., 1.], np.float32),
                  np.full(24, 0.05, np.float32))}


@pytest.fixture(scope="module")
def models():
    jm, tm = j_load_model(), t_load_model()
    return jm, JC.make_centroidal_info(jm), tm, TC.make_centroidal_info(tm)


def _args(flags, vq):
    x = np.zeros(30, dtype=np.float32)
    x[6:30] = default_q(base_pos=(0, 0, 0.4))
    return (x, np.zeros(30, np.float32), np.zeros(30, np.float32), x[6:30],
            vq, flags, np.float32(0.002))


@pytest.mark.parametrize("case", list(CASES))
def test_mpc_wbc_update_matches_jax(models, case):
    jm, ji, tm, ti = models
    np_args = _args(*CASES[case])
    args = [torch.as_tensor(np.asarray(a)) for a in np_args]
    jgains, tgains = JGains(), TGains()
    tau_max = torch.as_tensor(tm.joint_effort, dtype=torch.float32)
    jeffort = jnp.asarray(jm.joint_effort, jnp.float32)

    # the stack against the JAX package's
    m_, stack = mpc_wbc_stack(tm, ti, tgains, tau_max, *args)
    xx, u, ul, q, v, fl, per = map(jnp.asarray, np_args)
    jmd, jd = JT.compute_wbc_data(jm, ji, xx, u, ul, q, v, fl, per)
    g = jgains
    jstack = (
        JT.floating_base_eom_task(jmd) + JT.torque_limits_task(jmd, jeffort)
        + JT.no_contact_motion_task(jmd)
        + JT.friction_cone_task(jmd, g.friction_coefficient),
        JT.base_height_task(jmd, jd, g.base_height_kp, g.base_height_kd)
        + JT.base_angular_task(jmd, jd, g.kp_base_angular, g.kd_base_angular)
        + JT.base_linear_task(jmd, jd, g.kp_base_linear, g.kd_base_linear)
        + JT.swing_leg_task(jmd, jd, g.kp_swing, g.kd_swing)
        .scaled(g.swing_task_weight),
        JT.contact_force_task(jmd, u))
    assert [t.A.shape[0] for t in stack] == [30, 18, 12]
    assert stack[0].D.shape[0] == 56
    for tt, jt in zip(stack, jstack):
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-3)

    # the pivoted cascade (default) against JAX's (hierarchical_mpc_wbc_
    # update is this cascade on this stack, then recover_torques)
    res = hierarchical_mpc_wbc_update(tm, ti, tgains, tau_max, *args)
    assert torch.equal(res.x_opt, hoqp_solve(list(stack)))
    xj = np.asarray(_J_CASCADE(list(jstack)))
    rj_torques = np.asarray(JT.recover_torques(jmd, jnp.asarray(xj)))
    s64 = [tuple(a.numpy().astype(np.float64) for a in t) for t in stack]
    xt, xj = np.asarray(res.x_opt, np.float64), xj.astype(np.float64)
    assert _residuals_ok(s64, xt, xj)
    j_cascade = _J_CASCADE
    rng = np.random.default_rng(0)
    oj = _objectives(s64, xj)
    spread, o_spread = 0.0, np.zeros_like(oj)
    for _ in range(4):
        xd = np.asarray(j_cascade([JT.Task(*[jnp.asarray(a.numpy() * (
            1.0 + 1e-7 * rng.standard_normal(a.shape)), jnp.float32)
            for a in t]) for t in stack]))
        spread = max(spread, float((recover_torques(
            m_, torch.from_numpy(xd)) - torch.from_numpy(
                rj_torques)).abs().max()))
        o_spread = np.maximum(o_spread, np.abs(
            _objectives(s64, xd.astype(np.float64)) - oj))
    ot = _objectives(s64, xt)
    assert (np.abs(ot - oj) <= 2.0 * o_spread + 0.2 * np.maximum(
        np.abs(oj), 1.0) + 0.6).all(), (ot, oj, o_spread)
    err = np.abs(res.torques.numpy() - rj_torques).max()
    assert err <= 2.0 * spread + 0.1, (err, spread)
    assert (res.torques.abs().numpy() <= tm.joint_effort + 1e-3).all()

    # fused_cascade=True: K1's plain version on CPU tensors
    before = K.launch_count
    fused = hierarchical_mpc_wbc_update(tm, ti, tgains, tau_max, *args,
                                        fused_cascade=True)
    assert torch.equal(fused.x_opt, K.cascade_plain(*stack))
    assert K.launch_count == before


@pytest.fixture(scope="module")
def jax_cycle(models):
    """The JAX MpcControlLoop's cycle at 0.3 s / 0.03 s (compiled once),
    its carry 0, target and stance-then-trot schedule, and the port's
    cycle of the same configuration on the CPU."""
    from qm_control_tpu.config import MpcConfig, QmConfig
    from qm_control_tpu.experiments import _standing_setup
    from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu.runtime.loop import LoopConfig as JLoopConfig
    from qm_control_tpu.runtime.mpc_loop import MpcControlLoop as JLoop

    from qm_control_tpu_torch.config import MpcConfig as TMpcConfig
    from qm_control_tpu_torch.config import QmConfig as TQmConfig
    from qm_control_tpu_torch.runtime.loop import LoopConfig
    jcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.3, dt=0.03,
                                          num_iterations=1))
    model, info, q0, s = _standing_setup(jcfg)
    jloop = JLoop(model, info, jcfg, JLoopConfig())
    target = target_from_knots([0.0, 9.0], [s, s])
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    gs.insert_template(GAIT_LIBRARY["trot"], 0.005)
    ms = gs.mode_schedule(0.0, 9.0)
    _, _, tm, ti = models
    tcfg = TQmConfig().with_(mpc=TMpcConfig(time_horizon=0.3, dt=0.03,
                                            num_iterations=1))
    tcycle = make_mpc_cycle(tm, ti, tcfg, LoopConfig(), device="cpu")
    tinputs = (target_from_numpy(np.asarray(target.times),
                                 np.asarray(target.states), device="cpu"),
               mode_schedule_from_numpy(np.asarray(ms.event_times),
                                        np.asarray(ms.modes), device="cpu"),
               tcfg.wbc)
    return jloop, q0, (target, ms), tcycle, tinputs


def _out(carry, m):
    """(fresh cost, fresh X, q, v, arm command, last torques, last
    forces, EE error) of one variant cycle."""
    b = carry.base
    return [np.asarray(a) for a in (m.mpc_cost, b.X_warm, b.plant.q,
                                    b.plant.v, carry.arm_cmd, m.torques,
                                    m.forces, m.ee_pos_err)]


_FLOORS = np.array([1e-3, 2e-3, 1e-4, 1e-3, 1e-4, 0.1, 1.0, 1e-4])


def test_two_mpc_cycles_match_jax(jax_cycle):
    from qm_control_tpu.runtime.mpc_loop import MpcCycleCarry as JCarry
    jloop, q0, (target, ms), tcycle, tinputs = jax_cycle

    def jax_two(c0):
        out, c = [], c0
        for _ in range(2):
            c, m = jloop._cycle(c, target, ms, jloop.gains)
            out.append((c, m))
        return out

    # the variant's cycle neither reads nor returns the MRT policy stack:
    # without it both cycles share one compiled JAX program
    jc0 = jloop.init_carry(q0)
    leaves = dict(_leaves(jc0.base), policy=None)
    jc0 = jc0._replace(base=jc0.base._replace(policy=None))
    ref = jax_two(jc0)
    rng = np.random.default_rng(1)
    band = [np.zeros(8), np.zeros(8)]
    for _ in range(2):
        qd = np.asarray(q0) * (1.0 + 1e-7 * rng.standard_normal(24))
        base = jc0.base._replace(plant=jc0.base.plant._replace(
            q=jnp.asarray(qd, jnp.float32)))
        dusted = jax_two(JCarry(base=base, arm_cmd=jc0.arm_cmd))
        for k in range(2):
            band[k] = np.maximum(band[k], [
                np.abs(a - b).max() for a, b in zip(_out(*ref[k]),
                                                     _out(*dusted[k]))])

    carry = MpcCycleCarry(base=cycle_carry_from_numpy(leaves, device="cpu"),
                          arm_cmd=torch.tensor(np.asarray(jc0.arm_cmd)))
    before = K.launch_count
    for k in range(2):
        carry, m = tcycle(carry, *tinputs)
        jc, jm = ref[k]
        gaps = np.array([np.abs(a - b).max() for a, b in zip(
            _out(jc, jm), _out(carry, m))])
        gaps[0] /= max(1.0, abs(float(jm.mpc_cost)))
        assert (gaps <= 2.0 * band[k] + _FLOORS).all(), (k, gaps, band[k])
        assert float(m.mpc_alpha) == float(jm.mpc_alpha)
        assert bool(m.safe) == bool(jm.safe) is True
        assert float(carry.base.t) == pytest.approx(float(jc.base.t),
                                                    abs=1e-6)
        assert carry.base.policy is None
    assert K.launch_count == before


def test_mpc_variant_standing_cut_cpu():
    from qm_control_tpu_torch.config import MpcConfig
    from qm_control_tpu_torch.experiments import (_default_cfg,
                                                  mpc_variant_standing)
    from qm_control_tpu_torch.runtime import MpcControlLoop
    cfg = _default_cfg().with_(mpc=MpcConfig(
        time_horizon=0.3, dt=0.03, num_iterations=1, mpc_frequency=20.0))
    before = K.launch_count
    r = mpc_variant_standing(cfg=cfg, duration=0.05, warmup=2,
                             transient=0.0, device="cpu")
    assert K.launch_count == before
    arrays = r.pop("log").as_arrays()
    assert all(np.isfinite(v).all() for v in arrays.values()
               if v.dtype.kind == "f")
    assert len(arrays["t"]) >= 5 and r["safe"]
    assert r["base_height_err_max_mm"] < 60.0
    assert r["arm_track_err_max_rad"] < 0.2
    assert r["ee_pos_err_max_mm"] < 120.0
    assert MpcControlLoop.__module__.endswith("runtime.mpc_loop")


@pytest.mark.slow
def test_mpc_variant_standing():
    """tests/test_mpc_loop.py:test_mpc_variant_standing through the port,
    at its configuration and bounds."""
    from qm_control_tpu_torch.experiments import (_default_cfg,
                                                  mpc_variant_standing)
    cfg = _default_cfg(horizon=0.4, dt=0.04)
    r = mpc_variant_standing(cfg, duration=1.0, warmup=10, transient=0.3,
                             device="cpu")
    assert r["safe"]
    assert r["base_height_err_max_mm"] < 60.0
    assert r["arm_track_err_max_rad"] < 0.2
    assert r["ee_pos_err_max_mm"] < 120.0


def test_device_rule(models):
    """The variant's entry points default to the card and raise without
    one."""
    from qm_control_tpu_torch.config import QmConfig
    from qm_control_tpu_torch.experiments import mpc_variant_standing
    from qm_control_tpu_torch.runtime import MpcControlLoop
    from qm_control_tpu_torch.runtime.loop import LoopConfig
    _, _, tm, ti = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: MpcControlLoop(tm, ti, QmConfig()),
                 lambda: make_mpc_cycle(tm, ti, QmConfig(), LoopConfig()),
                 lambda: mpc_variant_standing(duration=0.01, warmup=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
