"""Checkpoints to ``.npz`` in the JAX package's on-disk format (its
``checkpoint/store.py``), so each package restores the other's files.

A tree is nested dicts, lists and tuples of tensors, or a flat
``{"blocks.attn.wq": tensor}`` dict (the training params and the
federated population, whose dotted names are the JAX tree paths). Keys
on disk are the tree paths joined with ``/`` (``blocks/attn/wq``;
stacked leaves stay stacked), leaves are host numpy arrays, and dtypes
numpy lacks (bf16) are stored as f32. Restore reads into the structure,
dtypes and devices of a ``like`` tree of tensors. Step-numbered directories
(``step_%08d/`` with ``state.npz`` and ``meta.json``) with a retention
policy, like a tiny orbax.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

_SEP = "/"


def _paths(tree, prefix=""):
    """(disk key, leaf) of every tensor leaf in tree order; a dict key's
    dots are path separators."""
    if isinstance(tree, dict):
        for key, child in tree.items():
            yield from _paths(child, f"{prefix}{str(key).replace('.', _SEP)}"
                              f"{_SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _paths(child, f"{prefix}{i}{_SEP}")
    elif tree is not None:
        yield prefix[:-1], tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:            # no numpy bf16: f32 on disk
        t = t.to(torch.float32)
    return t.cpu().numpy()


def save_pytree(path: str, tree) -> None:
    flat = {key: _to_numpy(leaf) for key, leaf in _paths(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def _rebuild(like, leaves, prefix=""):
    if isinstance(like, dict):
        return {key: _rebuild(child, leaves,
                              f"{prefix}{str(key).replace('.', _SEP)}{_SEP}")
                for key, child in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(child, leaves, f"{prefix}{i}{_SEP}")
               for i, child in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    if like is None:
        return None
    return leaves(prefix[:-1], like)


def restore_pytree(path: str, like):
    """Restore into the structure of ``like`` (names must match), each
    leaf in its ``like`` leaf's dtype and on its device."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        return _rebuild(like, lambda key, ref: torch.from_numpy(
            np.array(data[key])).to(device=ref.device, dtype=ref.dtype))


class CheckpointManager:
    """step-numbered checkpoints with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state, metadata: Optional[dict] = None):
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        save_pytree(os.path.join(d, "state"), state)
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump({"step": step, **(metadata or {})}, f)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, like, step: Optional[int] = None):
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = step if step is not None else steps[-1]
        return restore_pytree(os.path.join(self._step_dir(step), "state"),
                              like), step
