"""Latency instrumentation (a copy of qm_control_tpu/utils/timers.py:
host-side numpy, nothing to port).

Replaces OCS2's benchmark::RepeatedTimer (used around the reference's MPC
and WBC solves, QMController.cpp:145-147, :319-324, with max/avg printed
at teardown :342-355). Adds percentiles — the BASELINE metric includes
p99 control-loop latency vs budget.
"""
import time

import numpy as np


class RepeatedTimer:
    """Wall-clock timer accumulating per-call intervals."""

    def __init__(self, name: str = ""):
        self.name = name
        self._samples = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        self._samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def count(self):
        return len(self._samples)

    def stats(self) -> dict:
        if not self._samples:
            return {"name": self.name, "count": 0}
        s = np.asarray(self._samples)
        return {
            "name": self.name,
            "count": int(s.size),
            "avg_ms": float(s.mean() * 1e3),
            "max_ms": float(s.max() * 1e3),
            "min_ms": float(s.min() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p99_ms": float(np.percentile(s, 99) * 1e3),
        }

    def summary(self) -> str:
        st = self.stats()
        if st["count"] == 0:
            return f"[{self.name}] no samples"
        return (f"[{st['name']}] n={st['count']} avg={st['avg_ms']:.3f}ms "
                f"max={st['max_ms']:.3f}ms p99={st['p99_ms']:.3f}ms")
