"""Carry parameters between the JAX package and the port.

The JAX package keeps a model as a nested dict (``{"fc0": {"w", "b"}}``);
the port keeps a flat ``{"fc0.w": tensor}`` dict with the same names and
layouts. Both directions work for one model, for agent-stacked (K, ...)
params, and for error-feedback residual trees (which share the params'
structure). Leaves are anything ``numpy.asarray`` accepts.

LM trees hold tuples too (``"periods.0.norm"``), and stack layers on a
leading axis: the JAX transformer every block, the encoder-decoder each
of its two stacks, the hybrid each position of its pattern period over
the whole periods; xLSTM keeps a tuple of per-layer dicts. Which leaf
and row a port param is, is each family's ``jax_name`` rule
(:mod:`repro_torch.models.api`), which its ``stack_params`` reads too:
:func:`lm_params_from_numpy` follows it from the JAX tree to the port's
per-layer names, :func:`lm_params_to_numpy` back.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.api import get_model
from repro_torch.models.layers import stack_layers


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


def _layout(cfg):
    """(the family's namespace, a module of ``cfg`` on ``meta``): the
    port's names and shapes, with no storage."""
    model = get_model(cfg)
    return model, model.init(cfg, device="meta")


def lm_params_from_numpy(tree, cfg, *,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """The JAX LM params → the port's state dict (``Transformer``,
    ``RecurrentGemma``, ``EncDec`` or ``XLSTM``), each param the row of
    its JAX leaf that the family's ``jax_name`` names (a copy) or the leaf
    itself. Layouts stay as JAX keeps them (MoE expert stacks stay (E, d,
    f)). A leaf whose shape is not the module's (a layer axis of another
    depth included) or a leaf the module lacks raises ``ValueError``."""
    model, module = _layout(cfg)
    flat = params_from_numpy(tree, device=device)
    rows: Dict[str, list] = {}
    for name, p in module.named_parameters():
        key, row = model.jax_name(module, name)
        rows.setdefault(key, []).append((name, row, tuple(p.shape)))
    if set(rows) != set(flat):
        raise ValueError(f"{cfg.name}: JAX leaves without a param "
                         f"{sorted(set(flat) - set(rows))}, params without "
                         f"a JAX leaf {sorted(set(rows) - set(flat))}")
    out = {}
    for key, entries in rows.items():
        t, (_, row, shape) = flat[key], entries[0]
        want = shape if row is None else (len(entries),) + shape
        if tuple(t.shape) != want:
            raise ValueError(f"{key} {tuple(t.shape)}: want {want}")
        for name, row, _ in entries:
            out[name] = t if row is None else t[row].clone()
    return out


def _tuples(node):
    """Nested dicts whose keys are all ``"0", "1", ...`` → tuples."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return tuple(node[str(i)] for i in range(len(node)))
    return node


def lm_params_to_numpy(params, cfg) -> dict:
    """The port's LM state dict (``{"blocks.<i>.<leaf>": tensor}``, or
    the module itself) → the JAX LM params as nested numpy, the inverse of
    :func:`lm_params_from_numpy`: the family's ``stack_params`` structure
    with its numbered groups as tuples (the hybrid's ``periods`` and
    ``rem``, xLSTM's ``blocks``). The hybrid's ``periods`` is None without
    a whole period and ``rem`` empty without a remainder, as the JAX init
    makes them."""
    if isinstance(params, dict):
        (model, module), named = _layout(cfg), params
    else:
        model, module = get_model(cfg), params
        named = dict(params.named_parameters())
    out = _tuples(params_to_numpy(stack_layers(
        named, lambda name: model.jax_name(module, name))))
    if cfg.rglru is not None:
        out.setdefault("periods", None)
        out.setdefault("rem", ())
    return out
