"""PyTorch port vs JAX reference: the closed-loop control tick.

1. Parity. Why the first cycle runs only the hold policy: with
   mrt_policy_lag=1 the JAX cycle solves a fresh MPC policy but its ticks
   execute the OLDEST policy of the MRT stack (loop.py:177-183), which
   init_carry seeded with a STANCE "hold current state" policy
   (loop.py:319-333). So the 10 ticks of JAX cycle 1 (1 kHz ticks, 100 Hz
   MPC) are exactly the port's run_ticks(carry, 10) from the same carry,
   although the port has no MPC stage yet. The carry is handed over
   through interop.cycle_carry_from_numpy. The JAX side runs with
   fused_wbc=True (on the CPU, fused_hoqp_reference), otherwise it would
   compare against the pivoted XLA cascade. Tolerances: plant q 1e-4,
   v 1e-3, last-tick torques 0.1 Nm and forces 1 N, each widened by twice
   the JAX loop's own spread under 1e-7 relative dust on q0 (measured in
   the test). The spawn at 0.38 m lands the feet during these 10 ms, and
   that stiff transient amplifies last-bit differences tick by tick, so
   after 10 ticks JAX against itself with dust differs by about as much
   as the port against JAX.
2. Sanity: 100 port ticks of the standing configuration of
   experiments.standing_ee_hold on the CPU stay finite and safe, the base
   height stays within 1 cm and the EE within 5 mm of the start, and the
   K1 launch counter does not move (CPU tensors run the plain version).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu_torch.config import MpcConfig as TMpcConfig
from qm_control_tpu_torch.config import QmConfig as TQmConfig
from qm_control_tpu_torch.interop import cycle_carry_from_numpy
from qm_control_tpu_torch.kernels import hoqp_fused as K
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import default_q, load_model
from qm_control_tpu_torch.runtime.estimator import rbd_state_from_plant
from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig

torch.set_num_threads(1)


def _tcfg(horizon, dt, iters):
    cfg = TQmConfig().with_(mpc=TMpcConfig(time_horizon=horizon, dt=dt,
                                           num_iterations=iters))
    return cfg.with_(wbc=dataclasses.replace(cfg.wbc, arm_settling_time=0.0))


def _leaves(carry):
    """JAX CycleCarry -> dict of numpy leaves (interop's input)."""
    p = carry.plant
    return dict(
        plant=dict(q=np.asarray(p.q), v=np.asarray(p.v), t=np.asarray(p.t),
                   cmd_buf=[np.asarray(b) for b in p.cmd_buf],
                   buf_head=np.asarray(p.buf_head),
                   anchors=np.asarray(p.anchors),
                   ee_wrench=np.asarray(p.ee_wrench)),
        W_warm=np.asarray(carry.W_warm), X_warm=np.asarray(carry.X_warm),
        input_last=np.asarray(carry.input_last),
        last_yaw=np.asarray(carry.last_yaw), t=np.asarray(carry.t),
        safe=np.asarray(carry.safe),
        policy={k: np.asarray(v) for k, v in carry.policy._asdict().items()})


def _metrics(carry, m):
    return (np.asarray(carry.plant.q), np.asarray(carry.plant.v),
            np.asarray(m.torques), np.asarray(m.forces))


def _gaps(a, b):
    return np.array([np.abs(np.asarray(x) - np.asarray(y)).max()
                     for x, y in zip(a, b)])


def test_first_cycle_matches_jax_control_loop():
    from qm_control_tpu.config import MpcConfig, QmConfig
    from qm_control_tpu.experiments import _standing_setup
    from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu.runtime.loop import ControlLoop as JLoop
    from qm_control_tpu.runtime.loop import LoopConfig as JLoopConfig

    jcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.3, dt=0.03,
                                          num_iterations=2))
    jcfg = jcfg.with_(wbc=dataclasses.replace(jcfg.wbc,
                                              arm_settling_time=0.0))
    model, info, q0, s = _standing_setup(jcfg)
    jloop = JLoop(model, info, jcfg, JLoopConfig(
        control_freq=1000.0, fused_wbc=True, mrt_policy_lag=1))
    target = target_from_knots([0.0, 9.0], [s, s])
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 9.0)
    jcarry0 = jloop.init_carry(q0)
    jcarry1, jm = jloop._cycle(jcarry0, target, ms, jloop.gains)

    tm = load_model()
    tloop = ControlLoop(tm, TC.make_centroidal_info(tm), _tcfg(0.3, 0.03, 2),
                        LoopConfig(control_freq=1000.0, mrt_policy_lag=1),
                        device="cpu")
    tcarry0 = cycle_carry_from_numpy(_leaves(jcarry0), device="cpu")
    own0 = tloop.init_carry(np.asarray(q0))
    np.testing.assert_allclose(own0.policy.X.numpy(), tcarry0.policy.X.numpy(),
                               atol=1e-5)
    tcarry1, out = tloop.run_ticks(tcarry0, 10)

    # the reference's own spread: the same JAX cycle from q0 with 1e-7
    # relative dust (the closed loop amplifies last-bit differences
    # ~2x per tick through the stiff-contact landing transient)
    rng = np.random.default_rng(0)
    ref = _metrics(jcarry1, jm)
    band = np.zeros(4)
    for _ in range(2):
        qd = np.asarray(q0) * (1.0 + 1e-7 * rng.standard_normal(24))
        cd = jcarry0._replace(plant=jcarry0.plant._replace(
            q=jnp.asarray(qd, jnp.float32)))
        band = np.maximum(band, _gaps(ref, _metrics(
            *jloop._cycle(cd, target, ms, jloop.gains))))
    port = (tcarry1.plant.q.numpy(), tcarry1.plant.v.numpy(),
            out.torques[-1].numpy(), out.forces[-1].numpy())
    gaps = _gaps(ref, port)
    floors = np.array([1e-4, 1e-3, 0.1, 1.0])     # q, v, torque, force
    assert (gaps <= 2.0 * band + floors).all(), (gaps, band)
    assert float(tcarry1.t) == pytest.approx(float(jcarry1.t), abs=1e-6)
    assert float(tcarry1.last_yaw) == pytest.approx(
        float(jcarry1.last_yaw), abs=1e-6)
    assert bool(tcarry1.safe) == bool(jcarry1.safe)


def test_standing_hold_100_ticks_cpu():
    tm = load_model()
    loop = ControlLoop(tm, TC.make_centroidal_info(tm), _tcfg(1.0, 0.015, 1),
                       LoopConfig(control_freq=1000.0), device="cpu")
    carry = loop.init_carry(default_q(base_pos=(0, 0, 0.38)))
    ee0 = rbd_state_from_plant(tm, carry.plant.q, carry.plant.v)[48:51]
    before = K.launch_count
    carry, out = loop.run_ticks(carry, 100)
    assert K.launch_count == before
    assert out.q.shape == (100, 24) and out.torques.shape == (100, 18)
    assert torch.isfinite(out.q).all() and torch.isfinite(out.torques).all()
    assert bool(out.safe.all())
    assert (out.q[:, 2] - 0.38).abs().max() < 0.01
    ee = rbd_state_from_plant(tm, carry.plant.q, carry.plant.v)[48:51]
    assert (ee - ee0).norm() < 0.005
    assert float(carry.t) == pytest.approx(0.1, abs=1e-5)


def test_device_rule():
    """Entry points default to the card and raise without one."""
    tm = load_model()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ControlLoop(tm, TC.make_centroidal_info(tm), _tcfg(1.0, 0.015, 1))
