"""The JAX package's own run of the smoke run's MPC-only controller
variant, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python docs/mpc_variant_reference_jax.py \
        [DRAW [KEY=VALUE ...]]

The call is the one chip_smoke.py makes through the PyTorch port on the
GPU, at full width (horizon 1.0 s, dt 0.015, 1 SQP iteration, the
pivoted WBC cascade, 500 Hz ticks of LoopConfig()):

    mpc_variant_standing(duration=0.75, transient=0.5, warmup=5)

DRAW k > 0 runs it from the spawn configuration q0 with 1e-7 relative
dust (numpy default_rng(k)): three draws give the JAX run's own spread,
which sets chip_smoke.py's margin. KEY=VALUE changes one argument of the
call (VALUE in JSON, e.g. duration=0.5). Prints one JSON line (the result
dict without its log, the draw, the changes, the periods run, the wall
time and the peak resident memory). The address space is capped at
10 GiB.
"""
import json
import resource
import sys
import time

resource.setrlimit(resource.RLIMIT_AS, (10 << 30, 10 << 30))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from qm_control_tpu import experiments as E  # noqa: E402

CALL = dict(duration=0.75, transient=0.5, warmup=5)

_SETUP = E._standing_setup


def _dusted_setup(draw):
    """experiments._standing_setup with q0 times (1 + 1e-7 N(0, 1))."""
    def dusted(cfg):
        model, info, q0, s = _SETUP(cfg)
        rng = np.random.default_rng(draw)
        q = np.asarray(q0, np.float64) * (1.0 + 1e-7
                                          * rng.standard_normal(24))
        return model, info, jax.numpy.asarray(q, jax.numpy.float32), s
    return dusted


def run(draw=0, changes=None):
    kw = {**CALL, **(changes or {})}
    if draw:
        E._standing_setup = _dusted_setup(draw)
    t0 = time.time()
    try:
        r = E.mpc_variant_standing(**kw)
    finally:
        E._standing_setup = _SETUP
    log = r.pop("log")
    r.update(draw=draw, changes=changes or {},
             periods=len(log.as_arrays()["t"]), wall_s=time.time() - t0,
             maxrss_gib=resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 2**20)
    print(json.dumps(r, default=lambda o: o.item()), flush=True)
    return r


if __name__ == "__main__":
    args = sys.argv[1:]
    draw = int(args[0]) if args else 0
    changes = {k: json.loads(v) for k, v in (a.split("=", 1)
                                              for a in args[1:])}
    run(draw, changes)
