"""PyTorch port vs JAX reference: runtime/hw.py, the hardware seam
(SimHardware behind the HardwareInterface protocol, and HardwareLoop), and
plant.zero_command.

- SimHardware: 100 hold writes (2 plant substeps each) from the same
  spawn against the JAX package's SimHardware, at
  tests/test_torch_runtime.py's plant tolerances (q 1e-5, v rtol 1e-5 /
  atol 1e-4, anchors 1e-5) and with identical contact flags.
- HardwareLoop: 5 inline ticks at horizon 0.12 s / dt 0.04 against a JAX
  HardwareLoop whose WBC the test rebuilds with fused_cascade=True (K1's
  cascade; the JAX class's default is the pivoted one, ROADMAP Queue 3):
  the observation within 1e-5 plus twice the JAX loop's own move under
  1e-7 dust on q0 (the spawn's landing transient moves JAX's own
  observation 3.9e-4 and 6.9e-4 by ticks 4 and 5, and its torques 1.86 Nm
  at tick 3), the torques within twice that move plus
  test_torch_wbc.py's 0.1 Nm, and each level's objective within twice
  JAX's own dust move plus test_torch_wbc.py's 0.2 max(|o|, 1) + 0.6.
- run_paced and the asynchronous start() raise when the native library
  cannot be built (nothing falls back).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.experiments import _default_cfg as j_default_cfg
from qm_control_tpu.experiments import _standing_setup as j_setup
from qm_control_tpu.gaits.library import GAIT_LIBRARY as J_GAITS
from qm_control_tpu.gaits.library import GaitSchedule as JGaitSchedule
from qm_control_tpu.ocp.reference import target_from_knots as j_target
from qm_control_tpu.runtime import hw as JH
from qm_control_tpu.runtime import plant as JP
from qm_control_tpu.wbc.wbc import hierarchical_wbc_update as j_update

from qm_control_tpu_torch import native
from qm_control_tpu_torch.experiments import _default_cfg, _standing_setup
from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
from qm_control_tpu_torch.ocp.reference import target_from_knots
from qm_control_tpu_torch.runtime import hw as TH
from qm_control_tpu_torch.runtime import plant as TP
from qm_control_tpu_torch.wbc.wbc import wbc_stack

torch.set_num_threads(1)

TICKS = 5
HORIZON = dict(horizon=0.12, dt=0.04)


def test_zero_command():
    cmd = TP.zero_command(device="cpu")
    jcmd = JP.zero_command()
    assert isinstance(cmd, TP.HybridCommand)
    for a, b in zip(cmd, jcmd):
        assert a.shape == b.shape == (18,) and a.dtype == torch.float32
        assert not a.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.zero_command()


def test_sim_hardware_read_write_matches_jax():
    jm, _, q0, _ = j_setup(j_default_cfg(**HORIZON))
    tm, _, tq0, _ = _standing_setup(_default_cfg(**HORIZON))
    jhw = JH.SimHardware(jm, q0)
    thw = TH.SimHardware(tm, tq0, device="cpu")
    jr, tr = jhw.read(), thw.read()
    assert isinstance(tr, TH.HWReading) and tr.stamp == jr.stamp == 0.0
    for a, b in zip(tr[:6], jr[:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    jhold = JP.HybridCommand(pos_des=jr.joint_pos,
                             vel_des=jnp.zeros(18, jnp.float32),
                             kp=jnp.full(18, 80.0, jnp.float32),
                             kd=jnp.full(18, 3.0, jnp.float32),
                             ff=jnp.zeros(18, jnp.float32))
    thold = TP.HybridCommand(*[torch.as_tensor(np.array(a)) for a in jhold])
    for _ in range(100):
        jhw.write(jhold)
        thw.write(thold)
        jr, tr = jhw.read(), thw.read()
        np.testing.assert_array_equal(tr.contact_flags.numpy(),
                                      np.asarray(jr.contact_flags))
    js, ts = jhw.state, thw.state
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), atol=1e-5)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ts.anchors.numpy(), np.asarray(js.anchors),
                               atol=1e-5)
    assert tr.stamp == pytest.approx(jr.stamp) == pytest.approx(0.2)
    # standing: all four feet load-bearing after the settle
    assert tr.contact_flags.sum() >= 3


def _levels(stack, x):
    """Per-level residual norms and the worst level-0 violation."""
    A0, b0, D, f = stack[0]
    return np.array([np.linalg.norm(A @ x - b) for A, b, _, _ in stack]
                    + [np.max(D @ x - f)])


def _jax_run(jloop, jhw, jm, q0, target, ms):
    """TICKS inline ticks of a (reset) JAX HardwareLoop from q0: the
    observations, torques and cascade solutions of each tick."""
    jhw.state = JP.init_plant_state(jnp.asarray(q0, jnp.float32), model=jm)
    jhw._t = 0.0
    jloop.solver.reset()
    jloop.policy, jloop.t, jloop._k = None, 0.0, 0
    jloop.est = JH.init_imu_estimator()
    jloop.wbc._input_last = jnp.zeros(30, jnp.float32)
    obs, taus, xs = [], [], []
    for _ in range(TICKS):
        res, x = jloop.tick(target, ms, jhw.state.q[:3], jhw.state.v[:3])
        obs.append(np.asarray(x))
        taus.append(np.asarray(res.torques))
        xs.append(np.asarray(res.x_opt, np.float64))
    return np.array(obs), np.array(taus), np.array(xs)


def test_hardware_loop_ticks_match_jax():
    jcfg = j_default_cfg(**HORIZON)
    jm, ji, q0, s = j_setup(jcfg)
    jhw = JH.SimHardware(jm, q0)
    jloop = JH.HardwareLoop(jm, ji, jcfg, jhw, async_mpc=False)
    jloop.wbc._update = jax.jit(partial(j_update, jm, ji,
                                        fused_cascade=True))
    jtarget = j_target([0.0, 3.0], [s, s])
    jms = JGaitSchedule(J_GAITS["stance"]).mode_schedule(0.0, 3.0)
    jobs, jtau, jx = _jax_run(jloop, jhw, jm, np.asarray(q0), jtarget, jms)
    rng = np.random.default_rng(0)
    obs_move, tau_move, dusted_x = np.zeros(TICKS), np.zeros(TICKS), []
    for _ in range(2):
        qd = np.asarray(q0, np.float64) * (1.0 + 1e-7
                                           * rng.standard_normal(24))
        dobs, dtau, dx = _jax_run(jloop, jhw, jm, qd, jtarget, jms)
        obs_move = np.maximum(obs_move, np.abs(dobs - jobs).max(axis=1))
        tau_move = np.maximum(tau_move, np.abs(dtau - jtau).max(axis=1))
        dusted_x.append(dx)

    cfg = _default_cfg(**HORIZON)
    tm, ti, tq0, _ = _standing_setup(cfg)
    thw = TH.SimHardware(tm, tq0, device="cpu")
    loop = TH.HardwareLoop(tm, ti, cfg, thw, async_mpc=False, device="cpu")
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cpu")
    # the task stack of each port tick, built from the WBC's own inputs
    stacks, update = [], loop.wbc.update

    def recording(state_des, input_des, q, v, flags, period, time):
        w = loop.wbc
        _, st = wbc_stack(tm, ti, w.gains, w.tau_max, state_des, input_des,
                          w._input_last, q, v, flags,
                          torch.as_tensor(period, dtype=torch.float32),
                          torch.as_tensor(time, dtype=torch.float32))
        stacks.append([tuple(a.numpy().astype(np.float64) for a in t)
                       for t in st])
        return update(state_des, input_des, q, v, flags, period, time)
    loop.wbc.update = recording
    lim = tm.joint_effort + 1e-3
    for k in range(TICKS):
        res, x = loop.tick(target, ms, thw.state.q[:3], thw.state.v[:3])
        np.testing.assert_allclose(x.numpy(), jobs[k], rtol=0,
                                   atol=1e-5 + 2.0 * obs_move[k])
        tau = res.torques.numpy()
        assert np.isfinite(tau).all() and (np.abs(tau) <= lim).all()
        err = np.abs(tau - jtau[k]).max()
        assert err <= 2.0 * tau_move[k] + 0.1, (k, err, tau_move[k])
        ot = _levels(stacks[k], res.x_opt.numpy().astype(np.float64))
        oj = _levels(stacks[k], jx[k])
        o_move = np.max([np.abs(_levels(stacks[k], d[k]) - oj)
                         for d in dusted_x], axis=0)
        assert (np.abs(ot - oj) <= 2.0 * o_move + 0.2 * np.maximum(
            np.abs(oj), 1.0) + 0.6).all(), (k, ot, oj, o_move)
    assert loop._k == TICKS and loop.t == pytest.approx(TICKS / 500.0)


def _broken_build(monkeypatch):
    def fail(force=False):
        raise RuntimeError("native: g++ failed (1):\nsimulated")
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "_lib", None)


def test_run_paced_and_start_raise_without_native(monkeypatch):
    cfg = _default_cfg(**HORIZON)
    tm, ti, q0, s = _standing_setup(cfg)
    target = target_from_knots([0.0, 3.0], [s, s], device="cpu")
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device="cpu")
    _broken_build(monkeypatch)
    hw = TH.SimHardware(tm, q0, device="cpu")
    inline = TH.HardwareLoop(tm, ti, cfg, hw, async_mpc=False, device="cpu")
    inline.start(target, ms, hw.state.q[:3], hw.state.v[:3])   # a no-op
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        inline.run_paced(3, target, ms, lambda: hw.state.q[:3],
                         lambda: hw.state.v[:3])
    assert inline._k == 0           # raised before the first tick
    loop = TH.HardwareLoop(tm, ti, cfg, hw, async_mpc=True, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        loop.start(target, ms, hw.state.q[:3], hw.state.v[:3])
    assert loop.mrt._thread is None
    loop.stop()


def test_device_rule():
    if torch.cuda.is_available():
        pytest.skip("the rule concerns machines without a GPU")
    cfg = _default_cfg(**HORIZON)
    tm, ti, q0, _ = _standing_setup(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TH.SimHardware(tm, q0)
    hw = TH.SimHardware(tm, q0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TH.HardwareLoop(tm, ti, cfg, hw, async_mpc=False)
