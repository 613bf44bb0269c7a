"""Checkpoint / resume for long runs (port of
qm_control_tpu/utils/checkpoint.py).

Any pytree of tensors (CycleCarry, BatchScenario, MpcPolicy, ...) round-
trips through one .npz: the leaves as numpy arrays, with the tree
structure (torch.utils._pytree's TreeSpec repr) and each leaf's kind
stored beside them. A file written by another program version, or by the
JAX package, whose structure differs from the one asked for raises
ValueError instead of misassigning leaves (the JAX package sorts dict
keys in its treedef; torch's pytree keeps insertion order, so the two
reprs never match).
"""
import json
import os

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

FORMAT = "qm_control_tpu_torch/pytree-npz/1"


def _kind(leaf) -> str:
    if leaf is None:
        return "none"
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, np.ndarray):
        return "array"
    if isinstance(leaf, (bool, int, float)):
        return type(leaf).__name__
    raise TypeError(f"checkpoint: unsupported leaf type {type(leaf)}")


def _encode(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_pytree(path: str, tree) -> None:
    """Serialize a pytree of tensors / arrays / Python scalars / None to
    `path` (.npz)."""
    leaves, spec = tree_flatten(tree)
    kinds = [_kind(l) for l in leaves]
    arrays = {}
    for i, (leaf, kind) in enumerate(zip(leaves, kinds)):
        if kind == "tensor":
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
        elif kind != "none":
            arrays[f"leaf_{i}"] = np.asarray(leaf)
    arrays["__format__"] = _encode(FORMAT)
    arrays["__treedef__"] = _encode(str(spec))
    arrays["__kinds__"] = _encode(kinds)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str, like, device="cuda"):
    """Load a snapshot saved by save_pytree; `like` supplies the tree
    structure (its leaf values are ignored). Tensor leaves land on
    `device`, with their stored dtype.

    The format tag, the stored TreeSpec and the leaf count are checked
    against `like`, so structure drift between the writing and reading
    program versions fails loudly."""
    from .. import resolve_device
    dev = resolve_device(device)
    data = np.load(path)
    if "__format__" not in data.files or json.loads(
            bytes(data["__format__"]).decode()) != FORMAT:
        raise ValueError(f"checkpoint {path} was not written by "
                         f"qm_control_tpu_torch.utils.checkpoint (format "
                         f"{FORMAT}); a JAX package checkpoint does not "
                         f"carry over")
    _, spec = tree_flatten(like)
    kinds = json.loads(bytes(data["__kinds__"]).decode())
    if len(kinds) != spec.num_leaves:
        raise ValueError(
            f"checkpoint {path} has {len(kinds)} leaves but the supplied "
            f"structure expects {spec.num_leaves}")
    stored = json.loads(bytes(data["__treedef__"]).decode())
    if stored != str(spec):
        raise ValueError(f"checkpoint {path} treedef mismatch:\n  stored:   "
                         f"{stored}\n  expected: {spec}")
    leaves = []
    for i, kind in enumerate(kinds):
        if kind == "none":
            leaves.append(None)
        elif kind == "tensor":
            leaves.append(torch.as_tensor(data[f"leaf_{i}"], device=dev))
        elif kind == "array":
            leaves.append(data[f"leaf_{i}"])
        else:
            leaves.append({"bool": bool, "int": int, "float": float}[kind](
                data[f"leaf_{i}"].item()))
    return tree_unflatten(leaves, spec)


class RunCheckpointer:
    """Periodic snapshots with retention for long runs."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree) -> str:
        path = os.path.join(self.directory, f"ckpt_{step:09d}.npz")
        save_pytree(path, tree)
        self._prune()
        return path

    def latest(self):
        """(step, path) of the newest checkpoint, or None."""
        ckpts = self._list()
        return ckpts[-1] if ckpts else None

    def restore_latest(self, like, device="cuda"):
        latest = self.latest()
        if latest is None:
            return None, None
        step, path = latest
        return step, load_pytree(path, like, device=device)

    def _list(self):
        out = []
        for f in sorted(os.listdir(self.directory)):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                out.append((int(f[5:-4]), os.path.join(self.directory, f)))
        return out

    def _prune(self):
        for _, path in self._list()[:-self.keep]:
            os.remove(path)
