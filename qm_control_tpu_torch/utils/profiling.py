"""Tracing and profiling (port of qm_control_tpu/utils/profiling.py).

- `device_trace(log_dir)`: context manager around torch.profiler that
  writes a Chrome trace (chrome://tracing, Perfetto) of the host and,
  when a GPU is present, the device into `log_dir`.
- `chained_latency`: per-call latency by differential chaining, the JAX
  module's method: time chains of k1 and k2 dependent calls and return
  (T2 - T1) / (k2 - k1), so the fixed cost around a chain cancels. On
  CUDA a chain is timed with CUDA events, on the CPU with perf_counter.
- `RepeatedTimer` (re-exported from .timers): p50/p99 around whole
  calls, on the card's stream with CUDA events.
- The port's named stages are torch.profiler record_function ranges
  (the modules' *_SPAN constants: hw.estimate, mpc.solve with
  sqp.linearize / sqp.riccati / sqp.line_search inside, mpc.evaluate,
  wbc.data, wbc.cascade, plant.step); `device_trace` records them.
"""
import contextlib
import os
import time
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves

from .timers import RepeatedTimer  # noqa: F401  (re-export)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the body with torch.profiler (the CPU, and CUDA when
    available) and write `log_dir`/trace.json as a Chrome trace. Yields
    the profiler; its `trace_path` is set on exit."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(prof.trace_path)


def _device(carry) -> torch.device:
    for leaf in tree_leaves(carry):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _time_chain(chain, device, reps: int) -> float:
    """Best of `reps` wall times of chain() in seconds, to completion."""
    chain()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            chain()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            best = min(best, time.perf_counter() - t0)
    return best


def chained_latency(step_fn: Callable, k1: int = 10, k2: int = 110,
                    reps: int = 5) -> float:
    """Per-call latency of `step_fn(carry) -> carry` in seconds by
    differential chaining: chains of k1 and k2 dependent calls, timed to
    completion, give (T2 - T1) / (k2 - k1).

    The initial carry is step_fn.init() if present, else a 0-d float32
    zero on the CPU; the carry's first tensor names the device whose
    clock times the chains (CUDA events on a GPU)."""
    init = getattr(step_fn, "init", lambda: torch.zeros(()))
    device = _device(init())

    def make(k):
        def chain():
            c = init()
            for _ in range(k):
                c = step_fn(c)
            return c
        return chain

    t1 = _time_chain(make(k1), device, reps)
    t2 = _time_chain(make(k2), device, reps)
    return max(t2 - t1, 0.0) / (k2 - k1)

