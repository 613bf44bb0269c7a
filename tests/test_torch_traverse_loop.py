"""PyTorch port vs JAX reference: traverse_ee_hold through the real closed
loop (MPC + WBC + plant) on the CPU, at a cut size: control_freq lowered
to 200 Hz (2 ticks of 5 plant steps per MPC period; at 100 Hz the closed
loop diverges in both packages), 0.05 s chunks (cfg.mpc.mpc_frequency
20), the stance settle, the EE hold captured at 0.5 s and one chunk of
walking at a step command (0.55 s, 110 ticks). The experiment's later
branches (the ramp, the taper, the goal and the gait switch, the error
windows) are held against the JAX function by
tests/test_torch_experiments.py's scripted loop. The bound is
tests/test_torch_experiments_loop.py's: twice the JAX run's own spread
under 1e-7 dust on q0 (three draws) plus a floor.
"""
import torch

from qm_control_tpu_torch import experiments as TE
from test_torch_experiments_loop import _cfgs, _jax_runs, _match

torch.set_num_threads(1)


def test_traverse_ee_hold_matches_jax(monkeypatch):
    jcfg, tcfg = _cfgs(mpc_frequency=20.0)
    kw = dict(speed=-0.1, max_time=0.55, warmup=2, control_freq=200.0,
              cmd_ramp_s=0.0)
    ref, dusted = _jax_runs(monkeypatch, "traverse_ee_hold", jcfg, kw)
    out = TE.traverse_ee_hold(cfg=tcfg, device="cpu", **kw)
    _match(ref, dusted, out, exact=("reference_target_mm",
                                    "reference_target_deg"))
    assert out["safe"] and len(out["log"]) == len(ref["log"]) >= 55
    assert out["distance_reached_m"] > 0.0      # it walked
