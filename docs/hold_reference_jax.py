"""The JAX package's own run of the smoke run's main path, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python docs/hold_reference_jax.py

experiments.standing_ee_hold(gait="trot", duration=0.25, transient=0.0,
warmup=25) at full width (horizon 1.0 s, dt 0.015, 1 kHz ticks), the call
that chip_smoke.py phase 4b makes through the PyTorch port on the GPU.
Prints the result dict (without its log) as one JSON line. The address
space is capped at 10 GiB; the run holds ~1.6 GiB and takes ~2 minutes.
"""
import json
import resource
import time

resource.setrlimit(resource.RLIMIT_AS, (10 << 30, 10 << 30))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from qm_control_tpu.experiments import standing_ee_hold  # noqa: E402

if __name__ == "__main__":
    t0 = time.time()
    r = standing_ee_hold(gait="trot", duration=0.25, transient=0.0,
                         warmup=25)
    r.pop("log")
    r["wall_s"] = time.time() - t0
    r["maxrss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(r))
