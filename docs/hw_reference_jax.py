"""The JAX package's own run of the smoke run's hardware seam, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python docs/hw_reference_jax.py [DRAW]

The call is the one chip_smoke.py phase 4g(a) makes through the PyTorch
port on the GPU, at full width (horizon 1.0 s, dt 0.015, 1 SQP
iteration, arm_settling_time 0): runtime.hw.HardwareLoop(async_mpc=False)
over SimHardware(substeps=2) from experiments._standing_setup's q0 at
0.38 m, the hold target and the stance schedule, 100 ticks at 500 Hz
(20 MPC periods), with the JAX package's default WBC cascade.

DRAW k > 0 runs it from q0 with 1e-7 relative dust (numpy
default_rng(k)): three draws give the JAX run's own spread, which sets
chip_smoke.py's band. Prints one JSON line: the final base height, the
largest |tau| over the run, the base height's largest distance from
0.38 m, whether every torque was finite and within the joint limits
(+ 1e-3), the draw, the wall time and the peak resident memory. The
address space is capped at 10 GiB.
"""
import json
import resource
import sys
import time

resource.setrlimit(resource.RLIMIT_AS, (10 << 30, 10 << 30))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from qm_control_tpu.experiments import (_default_cfg,  # noqa: E402
                                        _standing_setup)
from qm_control_tpu.gaits.library import GAIT_LIBRARY, GaitSchedule  # noqa: E402
from qm_control_tpu.ocp.reference import target_from_knots  # noqa: E402
from qm_control_tpu.runtime.hw import HardwareLoop, SimHardware  # noqa: E402

TICKS = 100


def run(draw: int) -> dict:
    cfg = _default_cfg()
    model, info, q0, s = _standing_setup(cfg)
    q0 = np.asarray(q0, np.float64)
    if draw:
        rng = np.random.default_rng(draw)
        q0 = q0 * (1.0 + 1e-7 * rng.standard_normal(24))
    hw = SimHardware(model, jax.numpy.asarray(q0, jax.numpy.float32),
                     substeps=2)
    loop = HardwareLoop(model, info, cfg, hw, async_mpc=False)
    target = target_from_knots([0.0, 3.0], [s, s])
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0)
    lim = np.asarray(model.joint_effort)
    tau_max, dz, in_limits = 0.0, 0.0, True
    for _ in range(TICKS):
        res, _ = loop.tick(target, ms, hw.state.q[:3], hw.state.v[:3])
        tau = np.asarray(res.torques)
        in_limits &= bool(np.isfinite(tau).all()
                          and (np.abs(tau) <= lim + 1e-3).all())
        tau_max = max(tau_max, float(np.abs(tau).max()))
        dz = max(dz, abs(float(hw.state.q[2]) - 0.38))
    return dict(base_height_final=float(hw.state.q[2]), tau_abs_max=tau_max,
                base_height_dev_max=dz, in_limits=in_limits, ticks=TICKS)


if __name__ == "__main__":
    draw = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    t0 = time.time()
    r = run(draw)
    r.update(draw=draw, wall_s=time.time() - t0,
             maxrss_gib=resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 2**20)
    print(json.dumps(r))
