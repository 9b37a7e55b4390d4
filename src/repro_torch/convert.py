"""Carry parameters between the JAX package and the port.

The JAX package keeps a model as a nested dict (``{"fc0": {"w", "b"}}``);
the port keeps a flat ``{"fc0.w": tensor}`` dict with the same names and
layouts. Both directions work for one model, for agent-stacked (K, ...)
params, and for error-feedback residual trees (which share the params'
structure). Leaves are anything ``numpy.asarray`` accepts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(tree, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested dict of arrays → flat ``{"a.b": tensor}`` on ``device``."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in node:
                walk(node[key], f"{prefix}{key}.")
        else:
            arr = np.array(node)             # a writable host copy
            out[prefix[:-1]] = torch.from_numpy(arr).to(device)

    walk(tree, "")
    return out


def params_to_numpy(params: Dict[str, torch.Tensor]) -> dict:
    """Flat ``{"a.b": tensor}`` → nested dict of numpy arrays."""
    out: dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return out
