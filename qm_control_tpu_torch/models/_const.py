"""Cached device copies of the model's numpy constants.

The model (spec.RobotModel, centroidal.CentroidalInfo) holds numpy arrays.
Converting one on every call would cost a host-to-device copy per use on
the card, so each persistent array is converted once per (device, dtype).
The cache keeps a reference to the array, so its id is never reused.
"""
import numpy as np
import torch

_CACHE = {}


def const(array, like, dtype=None):
    """`array` (a persistent numpy array or tuple) as a tensor on the
    device of `like`, in `dtype` (default: like's dtype)."""
    dtype = like.dtype if dtype is None else dtype
    key = (id(array), like.device, dtype)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (array, torch.as_tensor(np.asarray(array), dtype=dtype,
                                      device=like.device))
        _CACHE[key] = hit
    return hit[1]


_SCALARS = {}


def scalar(value, like):
    """`value` (a Python or numpy number) as a cached 0-d tensor on the
    device and in the dtype of `like`. Under torch.func's forward mode, a
    0-d tensor times a Python float gets a float64 tangent (the float is
    not treated as a weak scalar there), so code that forward-mode
    differentiates 0-d scalars multiplies by these instead; the values are
    the same, as a Python float is rounded to the tensor's dtype anyway."""
    key = (float(value), like.device, like.dtype)
    hit = _SCALARS.get(key)
    if hit is None:
        hit = torch.tensor(float(value), dtype=like.dtype, device=like.device)
        _SCALARS[key] = hit
    return hit
