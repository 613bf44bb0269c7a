"""PyTorch port vs JAX reference: ControlLoop.escape, the basin-escape
re-initialization (JAX runtime/loop.py:344-391): a deep solve (12 SQP
iterations) from the QMInitializer start and one from the carry's warm
start, on identical data; the cold solution is adopted when it beats
the warm one by `margin`.

At tests/test_torch_loop.py's configuration (0.3 s / 0.03 s) on the
trot schedule, from two carries: the hold policy's warm start (the two
deep solves land together: kept), and a warm start of seeded random
inputs, N(0, 100 N) (12 iterations from it end at three times the cold
solve's cost: the cold solution is adopted). A zero-force warm start or
a plan displaced 30 cm converges in 12 iterations as well as the cold
start does, so it escapes nothing.
The same `escaped` flag as JAX, both deep solves' costs within 1e-3
relative (the MPC bound of tests/test_torch_mpc.py), and the adopted
warm start within that file's X 2e-3 / W 0.5 N.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_control_tpu.config import MpcConfig, QmConfig
from qm_control_tpu_torch.interop import cycle_carry_from_numpy
from qm_control_tpu_torch.models import centroidal as TC
from qm_control_tpu_torch.models import load_model as tload
from test_torch_loop import _leaves, _schedule, _tcfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loops():
    from qm_control_tpu.experiments import _standing_setup
    from qm_control_tpu.ocp.reference import target_from_knots
    from qm_control_tpu.runtime.loop import ControlLoop as JLoop
    from qm_control_tpu.runtime.loop import LoopConfig as JLoopConfig
    from qm_control_tpu_torch.interop import target_from_numpy
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    jcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.3, dt=0.03,
                                          num_iterations=2))
    jcfg = jcfg.with_(wbc=dataclasses.replace(jcfg.wbc,
                                              arm_settling_time=0.0))
    model, info, q0, s = _standing_setup(jcfg)
    jloop = JLoop(model, info, jcfg, JLoopConfig(control_freq=1000.0,
                                                 fused_wbc=True))
    target = target_from_knots([0.0, 9.0], [s, s])
    tm = tload()
    tloop = ControlLoop(tm, TC.make_centroidal_info(tm), _tcfg(0.3, 0.03, 2),
                        LoopConfig(control_freq=1000.0), device="cpu")
    ttarget = target_from_numpy(np.asarray(target.times),
                                np.asarray(target.states), device="cpu")
    return jloop, jloop.init_carry(q0), target, tloop, ttarget


@pytest.mark.parametrize("start,escapes", [("hold", False),
                                           ("poor", True)])
def test_escape_matches_jax(loops, start, escapes):
    jloop, jcarry, target, tloop, ttarget = loops
    ms, tms = _schedule("trot")
    if start == "poor":
        W = np.random.default_rng(0).normal(0.0, 100.0, jcarry.W_warm.shape)
        jcarry = jcarry._replace(W_warm=jnp.asarray(W, jnp.float32))
    jout, jesc = jloop.escape(jcarry, target, ms)
    jcold, jwarm = jloop._escape(jcarry, target, ms)
    tcarry = cycle_carry_from_numpy(_leaves(jcarry), device="cpu")
    tout, tesc = tloop.escape(tcarry, ttarget, tms)
    assert tesc == jesc == escapes
    for tc, jc in zip(tloop.escape_costs, (jcold.cost, jwarm.cost)):
        jc = float(jc)
        assert abs(float(tc) - jc) <= 1e-3 * max(1.0, abs(jc)), (
            float(tc), jc)
    np.testing.assert_allclose(tout.X_warm.numpy(), np.asarray(jout.X_warm),
                               atol=2e-3)
    np.testing.assert_allclose(tout.W_warm.numpy(), np.asarray(jout.W_warm),
                               atol=0.5)
    # only the warm start changes
    assert tout.plant is tcarry.plant and tout.policy is tcarry.policy
