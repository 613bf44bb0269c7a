"""MRT: real-time MPC <-> tracking decoupling with an asynchronous solver
thread (port of qm_control_tpu/runtime/mrt.py; OCS2's MPC_MRT_Interface
and the MPC worker thread, reference QMController.cpp:309-334 spawns the
thread, :133-141 exchanges observation and policy through the
interface's buffer):

  - the worker thread runs MpcSolver.solve paced to the MPC frequency,
    reading the newest observation from a slot;
  - the control thread publishes observations and reads the newest policy
    through a double buffer (realtime_tools::RealtimeBuffer);
  - evaluate() interpolates the current policy at t on the host.

On the card the worker calls torch.cuda.set_device first and solves under
its own torch.cuda.Stream, so the control tick's kernels (K1, the WBC,
the plant) never queue behind a solve's ~34,000 kernels on the shared
default stream. The observation it reads was made on the control
thread's stream: the publisher records an event after it, and the worker
waits for that event on its stream and marks the tensors as used there.
The worker copies each policy to the host once per solve; the control
thread never touches a device tensor of the worker. While the worker
replays a solve's CUDA graphs (mpc.mpc.solve_runner), the control
thread's own launches should not go to the legacy default stream, where
they stall: runtime/hw.py's HardwareLoop ticks on a stream of its own.
Both threads differentiate in forward mode, which torch does not make
thread-safe: models/_fwd.py serializes those calls, so the tick's WBC
waits while the solve linearizes; and both capture CUDA graphs, which
utils/graphs.py lets one thread do at a time.
"""
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..mpc.mpc import MpcPolicy, MpcSolver

JOIN_TIMEOUT_S = 120.0    # stop() waits this long for the solve in flight


def evaluate_policy_np(policy, t):
    """Host-side (numpy) policy interpolation — identical semantics to
    mpc.evaluate_policy but free of device dispatch, so the real-time
    thread's evaluate stays in the microsecond range even while the
    solver thread is busy (measured: eager jnp evaluate p99 was ~370 ms
    under solver contention)."""
    tn = policy.t_nodes
    idx = int(np.clip(np.searchsorted(tn, t, side="right") - 1, 0,
                      tn.shape[0] - 2))
    t0, t1 = tn[idx], tn[idx + 1]
    a = float(np.clip((t - t0) / max(t1 - t0, 1e-9), 0.0, 1.0))
    x = (1 - a) * policy.X[idx] + a * policy.X[idx + 1]
    u = (1 - a) * policy.U[idx] + a * policy.U[idx + 1]
    return x, u, int(policy.modes[idx])


class _Slot:
    """Single-value exchange (mutex-guarded swap; the writes are tiny host
    structs, matching realtime_tools::RealtimeBuffer)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._version = 0

    def write(self, value):
        with self._lock:
            self._value = value
            self._version += 1

    def read(self):
        with self._lock:
            return self._value, self._version


class _NativePolicySlot:
    """Policy exchange through the native seqlock PolicyBuffer: the
    real-time reader never blocks on the writer. A host MpcPolicy is
    flattened to one float32 vector in field order; the field shapes and
    dtypes are captured from the first write."""

    def __init__(self):
        self._buf = None
        self._shapes = None
        self._dtypes = None

    def write(self, policy: MpcPolicy):
        from .. import native
        leaves = [np.asarray(l) for l in policy]
        flat = np.concatenate([l.astype(np.float32).reshape(-1)
                               for l in leaves])
        if self._buf is None:
            self._shapes = [l.shape for l in leaves]
            self._dtypes = [l.dtype for l in leaves]
            self._buf = native.PolicyBuffer(flat.size)
        self._buf.write(flat, stamp=float(policy.t_nodes[0]))

    def read(self):
        if self._buf is None:
            return None, 0
        res = self._buf.read()
        if res is None:
            return None, 0
        flat, _ = res
        leaves, ofs = [], 0
        for shp, dt in zip(self._shapes, self._dtypes):
            n = int(np.prod(shp)) if shp else 1
            leaves.append(flat[ofs:ofs + n].reshape(shp).astype(dt))
            ofs += n
        return MpcPolicy(*leaves), self._buf.version


class MpcMrtInterface:
    """Asynchronous MPC runner and policy double buffer. use_native=True
    exchanges the policy through the native seqlock buffer (built or
    raised on in start(), never in the worker); False picks the mutex
    slot."""

    def __init__(self, solver: MpcSolver, mpc_frequency: float = None,
                 use_native: bool = True):
        self.solver = solver
        self.freq = mpc_frequency or solver.cfg.mpc.mpc_frequency
        self.use_native = use_native
        self._obs = _Slot()       # (t, x, target, mode_schedule, event)
        self._policy = _NativePolicySlot() if use_native else _Slot()
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._solve_count = 0
        self._error: Optional[BaseException] = None

    # -- control-thread API -------------------------------------------------
    def set_current_observation(self, t, x, target, ms):
        """Publish (t, x, target, ms). CUDA tensors are marked with an
        event on the publishing thread's stream, which the worker waits
        for before it reads them."""
        event = None
        if isinstance(x, torch.Tensor) and x.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(x.device))
        self._obs.write((t, x, target, ms, event))

    def initial_policy_received(self) -> bool:
        return self._policy.read()[0] is not None

    def evaluate(self, t, x):
        """(x_des, u_des, mode) from the newest policy (evaluatePolicy);
        numpy arrays, computed on the host."""
        policy, _ = self._policy.read()
        if policy is None:
            raise RuntimeError("no policy yet — call start() and wait for "
                               "initial_policy_received()")
        return evaluate_policy_np(policy, t)

    def get_policy(self) -> Optional[MpcPolicy]:
        return self._policy.read()[0]

    # -- solver thread ------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        if self.use_native:
            from .. import native
            native.load()          # build or raise here, not in the worker
        dev = self.solver.device
        if dev.type == "cuda" and dev.index is None:
            # the worker thread starts on device 0: give it this thread's
            dev = torch.device("cuda", torch.cuda.current_device())
        self._running.set()
        self._thread = threading.Thread(target=self._loop, args=(dev,),
                                        daemon=True, name="mpc-worker")
        self._thread.start()

    def stop(self):
        """Stop and join the worker; re-raise what it raised (the
        reference's MPC-thread exception trap halts the controller,
        QMController.cpp:327-330)."""
        self._running.clear()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=JOIN_TIMEOUT_S)
            if th.is_alive():
                raise RuntimeError(f"the MPC worker did not stop within "
                                   f"{JOIN_TIMEOUT_S} s")
        if self._error is not None:
            raise self._error

    def _loop(self, dev):
        stream = None
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            stream = torch.cuda.Stream(device=dev)
        period = 1.0 / self.freq
        while self._running.is_set():
            tick = time.perf_counter()
            obs, _ = self._obs.read()
            if obs is not None:
                try:
                    host_policy = self._solve(obs, stream)
                except BaseException as e:     # trap -> surface on stop()
                    self._error = e
                    self._running.clear()
                    return
                self._policy.write(host_policy)
                self._solve_count += 1
            # executeAndSleep pacing (the OCS2 helper the reference uses)
            remaining = period - (time.perf_counter() - tick)
            if remaining > 0:
                time.sleep(remaining)

    def _solve(self, obs, stream):
        """One solve of the published observation on the worker's stream
        (None on the CPU); the policy copied to the host (one
        device-to-host transfer per solve)."""
        t, x, target, ms, event = obs
        if stream is not None:
            if event is not None:
                stream.wait_event(event)
            for a in tree_leaves((x, target, ms)):
                if isinstance(a, torch.Tensor) and a.is_cuda:
                    a.record_stream(stream)
        with torch.cuda.stream(stream):        # a no-op for None
            policy = self.solver.solve(t, x, target, ms)
            return MpcPolicy(*[a.detach().cpu().numpy() for a in policy])

    @property
    def solve_count(self):
        return self._solve_count
