"""PyTorch port vs JAX reference: the closed-loop control cycle.

1. Parity of the ticks. With mrt_policy_lag=1 the JAX cycle solves a fresh
   MPC policy but its ticks execute the OLDEST policy of the MRT stack
   (loop.py:177-183), which init_carry seeded with a STANCE "hold current
   state" policy (loop.py:319-333). So the 10 ticks of JAX cycle 1 (1 kHz
   ticks, 100 Hz MPC) are exactly the port's run_ticks(carry, 10) from
   the same carry. The carry is handed over through
   interop.cycle_carry_from_numpy. The JAX side runs with fused_wbc=True
   (on the CPU, fused_hoqp_reference), otherwise it would compare against
   the pivoted XLA cascade. Tolerances: plant q 1e-4, v 1e-3, last-tick
   torques 0.1 Nm and forces 1 N, each widened by twice the JAX loop's
   own spread under 1e-7 relative dust on q0 (measured in the test). The
   spawn at 0.38 m lands the feet during these 10 ms, and that stiff
   transient amplifies last-bit differences tick by tick, so after 10
   ticks JAX against itself with dust differs by about as much as the
   port against JAX.
2. Parity of two whole cycles (make_cycle: estimator, MPC solve, MRT
   lag-stack roll, ticks, metrics): cycle 2's ticks execute cycle 1's
   fresh policy, so the MPC -> tick handoff is covered. The fresh
   policies (cost, X), the ticks' q, v, torques and forces and every
   CycleMetrics field are held within the same dust-band rule (twice
   the JAX loop's own spread over two cycles plus the floors above, and
   the MPC bounds of tests/test_torch_mpc.py for cost and X). Safety
   checks the fresh solve's cost, as in JAX.
3. Sanity: 100 port ticks of the standing configuration of
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
from qm_control_tpu_torch.interop import (cycle_carry_from_numpy,
                                          mode_schedule_from_numpy,
                                          target_from_numpy)
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


@pytest.fixture(scope="module")
def jax_loop():
    """The JAX ControlLoop at 0.3 s / 0.03 s / 2 iterations (its cycle is
    compiled once for the module), its target and carry 0, and the port's
    loop of the same configuration on the CPU."""
    from qm_control_tpu.config import MpcConfig, QmConfig
    from qm_control_tpu.experiments import _standing_setup
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
    tm = load_model()
    tloop = ControlLoop(tm, TC.make_centroidal_info(tm), _tcfg(0.3, 0.03, 2),
                        LoopConfig(control_freq=1000.0, mrt_policy_lag=1),
                        device="cpu")
    ttarget = target_from_numpy(np.asarray(target.times),
                                np.asarray(target.states), device="cpu")
    return jloop, q0, target, jloop.init_carry(q0), tloop, ttarget


def _schedule(gait):
    """Stance, or stance with `gait` inserted at 5 ms (its first contact
    switch, after the 0.1 s transition stance, lies inside the 0.3 s
    horizon of both cycles)."""
    from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    if gait != "stance":
        gs.insert_template(GAIT_LIBRARY[gait], 0.005)
    ms = gs.mode_schedule(0.0, 9.0)
    return ms, mode_schedule_from_numpy(np.asarray(ms.event_times),
                                        np.asarray(ms.modes), device="cpu")


def test_first_cycle_matches_jax_control_loop(jax_loop):
    jloop, q0, target, jcarry0, tloop, _ = jax_loop
    ms, _ = _schedule("stance")
    jcarry1, jm = jloop._cycle(jcarry0, target, ms, jloop.gains)

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


def _cycle_out(carry, m):
    """(fresh policy cost, fresh policy X, q, v, last torques, last forces)
    of one cycle (with mrt_policy_lag=1 the stack holds the fresh policy)."""
    return (np.asarray(m.mpc_cost), np.asarray(carry.policy.X[0]),
            np.asarray(carry.plant.q), np.asarray(carry.plant.v),
            np.asarray(m.torques), np.asarray(m.forces))


_OUT_FLOORS = (1e-3, 2e-3, 1e-4, 1e-3, 0.1, 1.0)
# CycleMetrics floors (the JAX spread is added on top): positions and EE
# errors as q, angles as q, forces/torques/cost as above
_METRIC_FLOORS = dict(
    ee_pos_err=1e-4, ee_ori_err=1e-4, base_height=1e-4, mpc_cost=1e-3,
    base_pose=1e-4, ee_pos=1e-4, ee_ref=1e-6, feet_pos=1e-4, forces=1.0,
    torques=0.1, x_des=2e-3, mpc_alpha=0.0, mpc_defect=1e-4)


def _within(gaps, band, floors, what):
    gaps, band, floors = map(np.asarray, (gaps, band, floors))
    assert (gaps <= 2.0 * band + floors).all(), (what, gaps, band)


def test_two_cycles_match_jax_control_loop(jax_loop):
    """Two make_cycle periods from the same carry in both packages: the
    MPC stage, the lag-1 handoff (cycle 2 executes cycle 1's policy), the
    ticks and the metrics; ControlLoop.run logs them."""
    from qm_control_tpu_torch.utils.viz import TrajectoryLog
    jloop, q0, target, jcarry0, tloop, ttarget = jax_loop
    ms, tms = _schedule("trot")

    def jax_two(c0):
        c1, m1 = jloop._cycle(c0, target, ms, jloop.gains)
        c2, m2 = jloop._cycle(c1, target, ms, jloop.gains)
        return (c1, m1), (c2, m2)

    ref = jax_two(jcarry0)
    # over two cycles the spread is wider and varies more from draw to
    # draw than over one (q 1e-5..9e-4 after cycle 2): six draws
    rng = np.random.default_rng(1)
    band = [np.zeros(6), np.zeros(6)]
    mband = [{k: 0.0 for k in _METRIC_FLOORS} for _ in range(2)]
    for _ in range(6):
        qd = np.asarray(q0) * (1.0 + 1e-7 * rng.standard_normal(24))
        dusted = jax_two(jcarry0._replace(plant=jcarry0.plant._replace(
            q=jnp.asarray(qd, jnp.float32))))
        for k in range(2):
            band[k] = np.maximum(band[k], _gaps(_cycle_out(*ref[k]),
                                                _cycle_out(*dusted[k])))
            for f in _METRIC_FLOORS:
                mband[k][f] = max(mband[k][f], float(np.abs(
                    np.asarray(getattr(ref[k][1], f), np.float64)
                    - np.asarray(getattr(dusted[k][1], f),
                                 np.float64)).max()))

    log = TrajectoryLog()
    carry = cycle_carry_from_numpy(_leaves(jcarry0), device="cpu")
    port = []
    for k in range(2):
        carry, m = tloop.run(carry, ttarget, tms, num_cycles=1, log=log)
        port.append((carry, m))
        pm = type(m)(*[a[0] for a in m])
        out = _cycle_out(carry, pm)
        jc, jm = ref[k]
        gaps = _gaps(_cycle_out(jc, jm), out)
        gaps[0] /= max(1.0, abs(float(jm.mpc_cost)))
        _within(gaps, band[k], _OUT_FLOORS, f"cycle {k + 1}")
        mg = {f: float(np.abs(np.asarray(getattr(jm, f), np.float64)
                              - getattr(pm, f).numpy().astype(np.float64)
                              ).max()) for f in _METRIC_FLOORS}
        _within(list(mg.values()), list(mband[k].values()),
                list(_METRIC_FLOORS.values()), f"metrics {k + 1}: {mg}")
        assert bool(pm.safe) == bool(jm.safe) is True
        assert float(pm.mpc_alpha) == float(jm.mpc_alpha)
        assert float(carry.t) == pytest.approx(float(jc.t), abs=1e-6)
    # the lag-1 handoff: cycle 2 executed cycle 1's fresh policy, whose
    # t_nodes start at cycle 1's time
    assert float(port[0][0].policy.t_nodes[0, 0]) == pytest.approx(0.0)
    assert float(port[1][0].policy.t_nodes[0, 0]) == pytest.approx(0.01)
    assert len(log) == 2 and log.as_arrays()["ee_pos"].shape == (2, 3)
    assert tloop.cycle_timer.count >= 2


def test_safety_checks_the_fresh_solve_cost(jax_loop):
    """A carry whose EXECUTED policy has a non-finite cost while the fresh
    solve's is finite: the JAX cycle stays safe (it checks policy.cost of
    the fresh solve, loop.py:227) and so does the port's make_cycle;
    run_ticks, which has no fresh solve, checks the executed policy."""
    jloop, q0, target, jcarry0, tloop, ttarget = jax_loop
    ms, tms = _schedule("stance")
    bad = jcarry0._replace(policy=jcarry0.policy._replace(
        cost=jnp.full_like(jcarry0.policy.cost, jnp.nan)))
    jc, jm = jloop._cycle(bad, target, ms, jloop.gains)
    carry = cycle_carry_from_numpy(_leaves(bad), device="cpu")
    assert not bool(torch.isfinite(carry.policy.cost).all())
    tc, tm_ = tloop._cycle(carry, ttarget, tms, tloop.gains)
    assert bool(jm.safe) is True and bool(jc.safe) is True
    assert bool(tm_.safe) == bool(jm.safe)
    assert bool(torch.isfinite(tm_.mpc_cost))
    _, out = tloop.run_ticks(carry, 2)
    assert not bool(out.safe.any())


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
