"""PyTorch port vs JAX reference: the batched closed-loop cycle
(parallel/batch.py:make_batched_cycle).

One period, B = 2 (scenario 1 spawned 1 cm higher), 0.3 s / 0.03 s,
1 kHz ticks, the "xla" cascade, trot, in both packages from the same
carries (interop.cycle_carry_from_numpy); scenario 0 also against the
port's single-scenario cycle. Tolerance: the dust-band rule of
tests/test_torch_loop.py, twice the JAX batch's own spread under 1e-7
relative dust on q (two draws) plus the floors cost 1e-3 relative,
X 2e-3, q 1e-4, v 1e-3, torques 0.1 Nm, forces 1 N.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._pytree import tree_map

from qm_control_tpu.config import MpcConfig, QmConfig
from test_torch_loop import _leaves

from qm_control_tpu_torch import config as TCfg
from qm_control_tpu_torch.interop import (cycle_carry_from_numpy,
                                          mode_schedule_from_numpy,
                                          target_from_numpy)
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model
from qm_control_tpu_torch.parallel import make_batched_cycle
from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig

torch.set_num_threads(1)

_FLOORS = np.array([1e-3, 2e-3, 1e-4, 1e-3, 0.1, 1.0])


def _scenario_out(carry, m, i):
    """Scenario i of a batched cycle: (fresh cost, fresh policy X, q, v,
    last torques, last forces); lag 1 keeps the fresh policy."""
    return (np.asarray(m.mpc_cost)[i], np.asarray(carry.policy.X)[i, 0],
            np.asarray(carry.plant.q)[i], np.asarray(carry.plant.v)[i],
            np.asarray(m.torques)[i], np.asarray(m.forces)[i])


def _gaps(a, b):
    return np.array([np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max()
                     for x, y in zip(a, b)])


def test_batched_cycle_matches_jax_and_single_cycle(model):
    from qm_control_tpu.experiments import _standing_setup
    from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu.models import centroidal as JC
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu.parallel.batch import make_batched_cycle as jmake
    from qm_control_tpu.runtime.loop import LoopConfig as JLoopConfig
    jcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.3, dt=0.03,
                                          num_iterations=1))
    jcfg = jcfg.with_(wbc=dataclasses.replace(jcfg.wbc,
                                              arm_settling_time=0.0))
    tcfg = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=0.3, dt=0.03, num_iterations=1))
    tcfg = tcfg.with_(wbc=dataclasses.replace(tcfg.wbc,
                                              arm_settling_time=0.0))
    B = 2
    _, _, q0, s = _standing_setup(jcfg)
    jv, jmk = jmake(model, JC.make_centroidal_info(model), jcfg,
                    JLoopConfig(control_freq=1000.0, fused_wbc="xla"))
    jv = jax.jit(jv)
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    gs.insert_template(GAIT_LIBRARY["trot"], 0.005)

    def tile(a):
        return jnp.tile(jnp.asarray(a)[None], (B,) + (1,) * jnp.ndim(a))
    jms, jtarget = jax.tree_util.tree_map(tile, (
        gs.mode_schedule(0.0, 9.0), target_from_knots([0.0, 9.0], [s, s])))
    c0 = jmk(q0, B)
    c0 = c0._replace(plant=c0.plant._replace(
        q=c0.plant.q.at[1, 2].add(0.01)))
    jc1, jm1 = jv(c0, jtarget, jms, jcfg.wbc)
    rng = np.random.default_rng(2)
    band = [np.zeros(6) for _ in range(B)]
    for _ in range(2):
        qd = np.asarray(c0.plant.q) * (1.0 + 1e-7 * rng.standard_normal(
            (B, 24)))
        cd, md = jv(c0._replace(plant=c0.plant._replace(
            q=jnp.asarray(qd, jnp.float32))), jtarget, jms, jcfg.wbc)
        for i in range(B):
            band[i] = np.maximum(band[i], _gaps(_scenario_out(jc1, jm1, i),
                                                _scenario_out(cd, md, i)))

    tm = load_model()
    ti = TC.make_centroidal_info(tm)
    tc0 = cycle_carry_from_numpy(_leaves(c0), device="cpu")
    ttarget = target_from_numpy(np.asarray(jtarget.times),
                                np.asarray(jtarget.states), device="cpu")
    tms = mode_schedule_from_numpy(np.asarray(jms.event_times),
                                   np.asarray(jms.modes), device="cpu")
    loop_cfg = LoopConfig(control_freq=1000.0, fused_wbc="xla")
    tv, tmk = make_batched_cycle(tm, ti, tcfg, loop_cfg, device="cpu")
    own = tmk(q0, B)
    np.testing.assert_allclose(own.policy.X.numpy(), tc0.policy.X.numpy(),
                               atol=1e-5)
    assert own.plant.buf_head.dtype == torch.int64
    tc1, tm1 = tv(tc0, ttarget, tms, tcfg.wbc)
    for i in range(B):
        gaps = _gaps(_scenario_out(jc1, jm1, i), _scenario_out(tc1, tm1, i))
        gaps[0] /= max(1.0, abs(float(jm1.mpc_cost[i])))
        assert (gaps <= 2.0 * band[i] + _FLOORS).all(), (i, gaps, band[i])
        assert bool(tm1.safe[i]) and bool(jm1.safe[i])
    assert float((tc1.plant.q[1, 2] - tc1.plant.q[0, 2]).abs()) > 1e-3

    single = ControlLoop(tm, ti, tcfg, loop_cfg, device="cpu")
    sc, sm = single._cycle(*tree_map(lambda a: a[0], (tc0, ttarget, tms)),
                           tcfg.wbc)
    one = (sm.mpc_cost, sc.policy.X[0], sc.plant.q, sc.plant.v, sm.torques,
           sm.forces)
    gaps = _gaps(_scenario_out(tc1, tm1, 0), [a.numpy() for a in one])
    gaps[0] /= max(1.0, abs(float(sm.mpc_cost)))
    assert (gaps <= 2.0 * band[0] + _FLOORS).all(), (gaps, band[0])
