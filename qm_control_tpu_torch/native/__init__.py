"""ctypes binding of the native host-runtime library (port of
qm_control_tpu/native/__init__.py).

PolicyBuffer (seqlock policy snapshots), DelayLine (timestamped command
replay), RatePacer (absolute-deadline loop pacing) and
set_realtime_priority, from the package's own copy of the C++ source
(csrc/qm_native.cpp, byte-identical to the JAX package's). The library is
built with g++ on first use, not at import, into build/ (git-ignored),
under a name hashed from the source and the flags.

Nothing falls back: where the JAX binding sets AVAILABLE = False and its
callers switch to Python equivalents, a failed build or load here raises
with the compiler's output. The MRT's mutex slot stays an explicit choice
(`MpcMrtInterface(use_native=False)`).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "qm_native.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/qm_native.cpp into build/libqm_native_<hash>.so with
    g++; returns the library path. Raises with the compiler's output."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()
                                + " ".join(CXX_FLAGS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"libqm_native_{digest[:12]}.so")
    if os.path.exists(path) and not force:
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native: g++ not found; the host-runtime "
                           "library is built from csrc/qm_native.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native: g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load():
    """The loaded library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u64, dbl, vp = ctypes.c_uint64, ctypes.c_double, ctypes.c_void_p
            u8p = ctypes.POINTER(ctypes.c_ubyte)
            lib.policy_buffer_create.restype = vp
            lib.policy_buffer_create.argtypes = [u64]
            lib.policy_buffer_destroy.argtypes = [vp]
            lib.policy_buffer_write.argtypes = [vp, u8p, u64, dbl]
            lib.policy_buffer_read.restype = ctypes.c_int
            lib.policy_buffer_read.argtypes = [vp, u8p, u64,
                                               ctypes.POINTER(dbl)]
            lib.policy_buffer_version.restype = u64
            lib.policy_buffer_version.argtypes = [vp]
            lib.delay_line_create.restype = vp
            lib.delay_line_create.argtypes = [u64, u64]
            lib.delay_line_destroy.argtypes = [vp]
            lib.delay_line_push.argtypes = [vp, dbl, u8p]
            lib.delay_line_read.restype = ctypes.c_int
            lib.delay_line_read.argtypes = [vp, dbl, dbl, u8p]
            lib.rate_pacer_create.restype = vp
            lib.rate_pacer_create.argtypes = [dbl]
            lib.rate_pacer_destroy.argtypes = [vp]
            lib.rate_pacer_sleep.restype = u64
            lib.rate_pacer_sleep.argtypes = [vp]
            lib.rate_pacer_overruns.restype = u64
            lib.rate_pacer_overruns.argtypes = [vp]
            lib.set_realtime_priority.restype = ctypes.c_int
            lib.set_realtime_priority.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def _as_u8(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


class _Handle:
    """Owns one native object; destroys it with the library's function."""
    _destroy = None

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            getattr(self._lib, self._destroy)(h)
            self._h = None


class PolicyBuffer(_Handle):
    """Lock-free (seqlock) snapshot buffer for flat float32 payloads."""
    _destroy = "policy_buffer_destroy"

    def __init__(self, num_floats: int):
        self._lib = load()
        self.num_floats = num_floats
        self._h = self._lib.policy_buffer_create(4 * num_floats)

    def write(self, arr: np.ndarray, stamp: float = 0.0):
        flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        if flat.size != self.num_floats:
            raise ValueError(f"payload of {flat.size} floats, buffer holds "
                             f"{self.num_floats}")
        self._lib.policy_buffer_write(self._h, _as_u8(flat), 4 * flat.size,
                                      float(stamp))

    def read(self):
        """(array, stamp) of the newest consistent snapshot, or None. A
        new destination per call: a shared scratch would let two reader
        threads tear each other's snapshots at the Python layer."""
        stamp = ctypes.c_double()
        out = np.empty(self.num_floats, dtype=np.float32)
        ok = self._lib.policy_buffer_read(self._h, _as_u8(out),
                                          4 * self.num_floats,
                                          ctypes.byref(stamp))
        return (out, stamp.value) if ok else None

    @property
    def version(self):
        return int(self._lib.policy_buffer_version(self._h))


class DelayLine(_Handle):
    """Timestamped ring buffer replaying float32 records `delay` s old."""
    _destroy = "delay_line_destroy"

    def __init__(self, num_floats: int, capacity: int = 256):
        self._lib = load()
        self.num_floats = num_floats
        self._h = self._lib.delay_line_create(4 * num_floats, capacity)
        self._scratch = np.empty(num_floats, dtype=np.float32)

    def push(self, stamp: float, rec: np.ndarray):
        flat = np.ascontiguousarray(rec, dtype=np.float32).reshape(-1)
        if flat.size != self.num_floats:
            raise ValueError(f"record of {flat.size} floats, line holds "
                             f"{self.num_floats}")
        self._lib.delay_line_push(self._h, float(stamp), _as_u8(flat))

    def read(self, now: float, delay: float):
        ok = self._lib.delay_line_read(self._h, float(now), float(delay),
                                       _as_u8(self._scratch))
        return self._scratch.copy() if ok else None


class RatePacer(_Handle):
    """Drift-free loop pacing via clock_nanosleep(TIMER_ABSTIME)."""
    _destroy = "rate_pacer_destroy"

    def __init__(self, frequency_hz: float):
        self._lib = load()
        self._h = self._lib.rate_pacer_create(float(frequency_hz))

    def sleep(self) -> int:
        """Sleep to the next absolute deadline; returns missed periods."""
        return int(self._lib.rate_pacer_sleep(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.rate_pacer_overruns(self._h))


def set_realtime_priority(priority: int = 50) -> bool:
    """Switch the calling thread to SCHED_FIFO (reference threadPriority
    50, task.info:38). Returns False without the privilege to do so."""
    return load().set_realtime_priority(int(priority)) == 0
