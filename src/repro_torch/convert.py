"""Carry parameters between the JAX package and the port.

The JAX package keeps a model as a nested dict (``{"fc0": {"w", "b"}}``);
the port keeps a flat ``{"fc0.w": tensor}`` dict with the same names and
layouts. Both directions work for one model, for agent-stacked (K, ...)
params, and for error-feedback residual trees (which share the params'
structure). Leaves are anything ``numpy.asarray`` accepts.

LM trees hold tuples too (``"periods.0.norm"``). The JAX hybrid stacks
its blocks by pattern period and the JAX transformer every block on one
leading layer axis: :func:`lm_params_from_numpy` unstacks both into the
port's ``blocks.<layer>.`` names in layer order, and
:func:`lm_params_to_numpy` stacks them back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(tree, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Nested dicts and tuples of arrays → flat ``{"a.0.b": tensor}`` on
    ``device`` (``None`` subtrees are skipped)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key in node:
                walk(node[key], f"{prefix}{key}.")
        elif isinstance(node, (tuple, list)):
            for i, child in enumerate(node):
                walk(child, f"{prefix}{i}.")
        elif node is not None:
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


def lm_params_from_numpy(tree, cfg, *, device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX LM params → the port's state dict (``RecurrentGemma`` or
    ``Transformer``). Layouts stay as JAX keeps them (MoE expert stacks
    stay (E, d, f)).

    Transformer: ``blocks`` is stacked over the layers, its row i is
    layer i. Hybrid: ``periods[j]`` is stacked over the ``n_full`` whole
    pattern periods, its row i is layer ``i·len(pattern) + j``; ``rem[j]``
    is layer ``n_full·len(pattern) + j``."""
    P = len(cfg.rglru.block_pattern) if cfg.rglru is not None else 1
    n_full = cfg.num_layers // P
    out = {}
    for name, t in params_from_numpy(tree, device=device).items():
        group, _, rest = name.partition(".")
        if group == "blocks":
            for i in range(cfg.num_layers):
                out[f"blocks.{i}.{rest}"] = t[i].clone()
            continue
        if group not in ("periods", "rem"):
            out[name] = t
            continue
        j, _, leaf = rest.partition(".")
        if group == "rem":
            out[f"blocks.{n_full * P + int(j)}.{leaf}"] = t
        else:
            for i in range(n_full):
                out[f"blocks.{i * P + int(j)}.{leaf}"] = t[i].clone()
    return out


def lm_params_to_numpy(params, cfg) -> dict:
    """The port's LM state dict (``{"blocks.<i>.<leaf>": tensor}``, or
    the module itself) → the JAX LM params as nested numpy: the inverse
    of :func:`lm_params_from_numpy`. Transformer: ``blocks.<leaf>``
    stacked over the layers. Hybrid: ``periods`` a tuple (one entry per
    pattern position j) stacked over the ``n_full`` whole periods, ``rem``
    a tuple of the remainder layers, ``periods`` None without a whole
    period, as the JAX init makes them."""
    if not isinstance(params, dict):
        params = params.state_dict()
    layers: Dict[int, dict] = {}
    flat = {}
    for name, t in params.items():
        group, _, rest = name.partition(".")
        if group == "blocks":
            i, _, leaf = rest.partition(".")
            layers.setdefault(int(i), {})[leaf] = t.detach()
        else:
            flat[name] = t
    L = cfg.num_layers

    def stack(rows):
        return {leaf: torch.stack([r[leaf] for r in rows])
                for leaf in rows[0]}

    out = params_to_numpy(flat)
    if cfg.rglru is None:
        out["blocks"] = params_to_numpy(
            stack([layers[i] for i in range(L)]))
        return out
    P = len(cfg.rglru.block_pattern)
    n_full = L // P
    out["periods"] = (tuple(
        params_to_numpy(stack([layers[i * P + j] for i in range(n_full)]))
        for j in range(P)) if n_full else None)
    out["rem"] = tuple(params_to_numpy(layers[n_full * P + j])
                       for j in range(L - n_full * P))
    return out
