"""Latency instrumentation (port of qm_control_tpu/utils/timers.py).

Replaces OCS2's benchmark::RepeatedTimer (used around the reference's MPC
and WBC solves, QMController.cpp:145-147, :319-324, with max/avg printed
at teardown :342-355). Adds percentiles — the BASELINE metric includes
p99 control-loop latency vs budget.
"""
import time

import numpy as np
import torch


class RepeatedTimer:
    """Timer accumulating per-call intervals.

    On the CPU each interval is the host's perf_counter between start()
    and stop(). With a CUDA `device` the host clock would time only the
    enqueue, since PyTorch returns before the card has run the work: each
    interval is instead a pair of CUDA events recorded on the device's
    current stream, from the stream reaching start() to the stream
    finishing what was enqueued before stop(). The pairs are resolved in
    stats(), after one synchronise there, so the timed loop gets no
    synchronise of its own."""

    def __init__(self, name: str = "", device=None):
        self.name = name
        self._device = None if device is None else torch.device(device)
        self._cuda = self._device is not None and \
            self._device.type == "cuda"
        self._samples = []      # seconds
        self._pending = []      # (start, end) CUDA events, not yet read
        self._t0 = None

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self._device))
        return e

    def start(self):
        self._t0 = self._event() if self._cuda else time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        if self._cuda:
            self._pending.append((self._t0, self._event()))
        else:
            self._samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    @property
    def count(self):
        return len(self._samples) + len(self._pending)

    def _resolve(self):
        """Read the pending CUDA event pairs into seconds."""
        if self._pending:
            self._pending[-1][1].synchronize()
            self._samples += [a.elapsed_time(b) * 1e-3
                              for a, b in self._pending]
            self._pending = []

    def stats(self) -> dict:
        self._resolve()
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
