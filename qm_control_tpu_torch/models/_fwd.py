"""Forward-mode transforms under one process-wide lock.

torch keeps the levels of forward-mode AD in process globals
(torch.autograd.forward_ad._current_level, torch._functorch's
JVP_NESTING and the C++ forward-grad level table), so two threads inside
jvp or jacfwd at once break each other's dual levels ("Trying to create a
dual Tensor for forward AD but no level exists"); vmap and grad keep
their state per thread. The hardware loop runs the MPC solve on a worker
thread beside the control tick, and both differentiate in forward mode,
so every forward-mode transform of the package goes through these
wrappers: the outermost call on a thread holds LOCK (re-entrant) for as
long as it runs, and the other thread waits for it.
"""
import threading
from functools import wraps

from torch.func import jacfwd as _jacfwd
from torch.func import jvp as _jvp

LOCK = threading.RLock()


def jvp(*args, **kwargs):
    """torch.func.jvp under LOCK."""
    with LOCK:
        return _jvp(*args, **kwargs)


def jacfwd(func, *args, **kwargs):
    """torch.func.jacfwd, whose returned function runs under LOCK."""
    inner = _jacfwd(func, *args, **kwargs)

    @wraps(inner)
    def locked(*a, **k):
        with LOCK:
            return inner(*a, **k)
    return locked
