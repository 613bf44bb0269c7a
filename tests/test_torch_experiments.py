"""PyTorch port vs JAX reference: experiments.batched_rollouts (config #5,
the domain-randomized fleet of batched MPC solves) at
tests/test_experiments.py's _ci_cfg, B = 4, 2 steps, the same seed: the
same keys, finite_fraction 1.0, cost_mean within 1e-3 relative (the
tolerance of one MPC solve in tests/test_torch_mpc.py; measured 5e-6)."""
import dataclasses

import torch

from qm_control_tpu import experiments as JE
from test_experiments import _ci_cfg

from qm_control_tpu_torch import config as TCfg
from qm_control_tpu_torch import experiments as TE

torch.set_num_threads(1)


def test_batched_rollouts_match_jax():
    jr = JE.batched_rollouts(cfg=_ci_cfg(), batch=4, num_steps=2)
    tcfg = TCfg.QmConfig().with_(mpc=TCfg.MpcConfig(
        time_horizon=0.5, dt=0.025, num_iterations=1))
    tcfg = tcfg.with_(wbc=dataclasses.replace(tcfg.wbc,
                                              arm_settling_time=0.0))
    tr = TE.batched_rollouts(cfg=tcfg, batch=4, num_steps=2, device="cpu")
    assert tr.keys() == jr.keys()
    assert tr["experiment"] == jr["experiment"]
    assert tr["finite_fraction"] == jr["finite_fraction"] == 1.0
    assert abs(tr["cost_mean"] - jr["cost_mean"]) <= 1e-3 * abs(
        jr["cost_mean"])
