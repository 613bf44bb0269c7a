"""The JAX package's own runs of the smoke run's command-driven
experiments, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python docs/experiments_reference_jax.py \
        [CALL [DRAW [KEY=VALUE ...]]]

CALL is one of traverse, tracking, wrench_on, wrench_off (default: every
call, one after another). Each is the call that chip_smoke.py phase 4c
makes through the PyTorch port on the GPU, at full width (horizon 1.0 s,
dt 0.015, 1 SQP iteration):

    traverse    traverse_ee_hold(gait="trot", speed=-0.05, max_time=1.0,
                                 warmup=5)
    tracking    ee_tracking(duration=1.3, warmup=5)
    wrench_on   disturbance_rejection(ee_force=25.0, settle=0.2, hold=1.0,
                                      release=0.3, warmup=5,
                                      settle_band_mm=25.0,
                                      mpc_wrench_feedthrough=True)
    wrench_off  the same with mpc_wrench_feedthrough=False

DRAW k > 0 runs the same call from the spawn configuration q0 with 1e-7
relative dust (numpy default_rng(k)): three draws give the JAX run's own
spread, which sets chip_smoke.py's margin. KEY=VALUE changes one
argument of the call (VALUE in JSON, e.g. hold=0.5 or speed=-0.03: how
the depth of phase 4c was chosen, PERF.md §4). Prints one JSON line per
call (the result dict without its log, the call, the draw, the changes,
the wall time and the peak resident memory). The address space is capped
at 10 GiB; a run holds ~1.5 GiB and takes 2-6 minutes.
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

CALLS = {
    "traverse": (E.traverse_ee_hold,
                 dict(gait="trot", speed=-0.05, max_time=1.0, warmup=5)),
    "tracking": (E.ee_tracking, dict(duration=1.3, warmup=5)),
    "wrench_on": (E.disturbance_rejection,
                  dict(ee_force=25.0, settle=0.2, hold=1.0, release=0.3,
                       warmup=5, settle_band_mm=25.0,
                       mpc_wrench_feedthrough=True)),
    "wrench_off": (E.disturbance_rejection,
                   dict(ee_force=25.0, settle=0.2, hold=1.0, release=0.3,
                        warmup=5, settle_band_mm=25.0,
                        mpc_wrench_feedthrough=False)),
}


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


def run(name, draw=0, changes=None):
    fn, kw = CALLS[name]
    kw = {**kw, **(changes or {})}
    if draw:
        E._standing_setup = _dusted_setup(draw)
    t0 = time.time()
    try:
        r = fn(**kw)
    finally:
        E._standing_setup = _SETUP
    r.pop("log", None)
    r.pop("cycle_timer", None)
    r.update(call=name, draw=draw, changes=changes or {},
             wall_s=time.time() - t0,
             maxrss_gib=resource.getrusage(
                 resource.RUSAGE_SELF).ru_maxrss / 2**20)
    # numpy scalars (a non-finite run's `recovered` is np.bool_) as Python
    print(json.dumps(r, default=lambda o: o.item()), flush=True)
    return r


if __name__ == "__main__":
    args = sys.argv[1:]
    names = [args[0]] if args else list(CALLS)
    draw = int(args[1]) if len(args) > 1 else 0
    changes = {k: json.loads(v) for k, v in (a.split("=", 1)
                                              for a in args[2:])}
    for n in names:
        run(n, draw, changes)
