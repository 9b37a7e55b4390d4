"""The placement table: LM leaf names -> partition specs -> DTensor
placements (the port of the JAX package's ``sharding/rules.py``, the same
logic rule for rule).

* tensor parallelism over the mesh ``model`` axis: vocab, attention heads,
  kv heads, d_ff, the LRU width and its blocks, and the MoE experts' f
  dimension, whichever dim of each leaf carries that logical axis,
  guarded by divisibility (fallback: replicate);
* data parallelism over (``pod``, ``data``): params replicated, batch dim
  sharded;
* stacked per-layer leaves (a stack key in the path and no layer index)
  carry a leading layer dim, skipped by the offset.

The table is keyed on the JAX package's leaf names, which are the port's
too: each family's ``stack_params`` gives the flat ``{"blocks.attn.wq":
(L, d, H, hd)}`` dict and ``jax_name`` the rule behind it
(:mod:`repro_torch.models.api`). A spec is a tuple with one entry a
tensor dim: None, a mesh axis name, or a tuple of them (the batch over
``pod`` and ``data``), as a ``jax.sharding.PartitionSpec`` reads;
:func:`placements` turns it into a DTensor placement per mesh dim. A mesh
is a ``DeviceMesh`` or, for the specs alone, a ``{axis: size}`` mapping
(:func:`repro_torch.sharding.context.mesh_shape`).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.sharding.context import data_axes, mesh_shape


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


# leaf name -> {dim: logical axis}, dims AFTER any leading layer-stack dim
_RULES = {
    # embeddings
    "embed": {0: "vocab"},
    "unembed": {1: "vocab"},
    # attention
    "wq": {1: "heads"},
    "wk": {1: "kv_heads"},
    "wv": {1: "kv_heads"},
    "wo": {0: "heads"},
    # dense mlp
    "w_gate": {1: "mlp"},
    "w_up": {1: "mlp"},
    "w_down": {0: "mlp"},
    # moe (leaves under "mlp": router (d, E), w_* (E, d, f) / (E, f, d))
    "router": {},
    # rg-lru recurrent block
    "w_branch_x": {1: "lru"},
    "w_branch_gate": {1: "lru"},
    "w_a": {0: "lru_blocks"},       # block-diagonal (H, bw, bw)
    "w_x": {0: "lru_blocks"},
    "b_a": {0: "lru"},
    "b_x": {0: "lru"},
    "lam": {0: "lru"},
    "w_out": {0: "lru"},
    # xlstm
    "w_ff1": {1: "mlp"},
    "w_ff2": {0: "mlp"},
}

_STACK_KEYS = ("blocks", "periods", "enc_blocks", "dec_blocks", "rem")


def _is_stacked(names) -> bool:
    """Scan-over-layers stacks have a stack key in the path and NO integer
    path component (tuple-of-blocks paths hold the layer index)."""
    return (any(n in _STACK_KEYS for n in names)
            and not any(n.isdigit() for n in names))


def param_spec(names, shape, cfg, model_axis: str = "model",
               model_size: int = 1) -> tuple:
    """The spec of one param leaf at path ``names`` (its name split on
    dots) and ``shape``."""
    names = list(names)
    name = names[-1]
    ndim = len(shape)
    stacked = _is_stacked(names[:-1]) and ndim >= 1
    # MoE expert leaves: (E, d, f) / (E, f, d), shard the f dim
    in_moe = cfg.moe is not None and "mlp" in names and name in (
        "w_gate", "w_up", "w_down") and "shared" not in names
    offset = 1 if stacked else 0
    dims: dict = {}
    if in_moe:
        dims = {2: "mlp"} if name in ("w_gate", "w_up") else {1: "mlp"}
    elif name in _RULES:
        dims = _RULES[name]
    spec = [None] * ndim
    for dim, _logical in dims.items():
        d = dim + offset
        if d < ndim and _div(shape[d], model_size):
            spec[d] = model_axis
            break
    return tuple(spec)


def _model_size(mesh, model_axis: str) -> int:
    return mesh_shape(mesh).get(model_axis, 1)


def param_specs(params: Dict, cfg, mesh,
                model_axis: str = "model") -> Dict[str, tuple]:
    """``{name: spec}`` for a ``stack_params`` dict (tensors, or shapes)."""
    size = _model_size(mesh, model_axis)
    return {name: param_spec(name.split("."), tuple(getattr(t, "shape", t)),
                             cfg, model_axis, size)
            for name, t in params.items()}


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    each mesh dim that tensor dim d names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def param_placements(params: Dict, cfg, mesh,
                     model_axis: str = "model") -> Dict[str, list]:
    """``{name: DTensor placements}`` of a ``stack_params`` dict on
    ``mesh`` (replicated over the data axes)."""
    return {name: placements(s, mesh)
            for name, s in param_specs(params, cfg, mesh, model_axis).items()}


def batch_spec(mesh) -> tuple:
    """The batch dim's entry over every data-parallel mesh axis present
    (None without one)."""
    axes = data_axes(mesh)
    if not axes:
        return (None,)
    return (axes if len(axes) > 1 else axes[0],)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= shape.get(a, 1)
    return n


def data_spec(shape, mesh) -> tuple:
    """Dim 0 over (pod, data) when it divides, else replicated."""
    spec = [None] * len(shape)
    if len(shape) and _div(shape[0], dp_size(mesh)):
        spec[0] = batch_spec(mesh)[0]
    return tuple(spec)


def data_specs(batch: Dict, mesh) -> Dict[str, tuple]:
    """``{name: spec}`` of a batch dict (tensors, or shapes)."""
    return {k: data_spec(tuple(getattr(t, "shape", t)), mesh)
            for k, t in batch.items()}


def data_placements(batch: Dict, mesh) -> Dict[str, list]:
    return {k: placements(s, mesh) for k, s in data_specs(batch, mesh).items()}


def cache_spec(names, shape, mesh, model_axis: str = "model") -> tuple:
    """The spec of one cache leaf: batch dim over the data axes; a kv leaf
    ((L,) B, C, K, hd) also over ``model`` on its kv-head dim when that
    divides, else on head_dim (a stationary tensor-parallel cache: an
    unsharded one would be gathered whole every decode step)."""
    names = list(names)
    ndim = len(shape)
    size = _model_size(mesh, model_axis)
    baxes = batch_spec(mesh)[0]
    dp = dp_size(mesh)
    # 'periods' caches are period-stacked tuples: digits index the
    # within-period position, the leading dim is still the stack
    stacked = (_is_stacked(names) or "self" in names
               or "periods" in names) and ndim >= 2
    spec = [None] * ndim
    b_dim = 1 if (stacked and ndim >= 2) else 0
    if names[-1] in ("k", "v") and ndim >= 4:
        b_dim = ndim - 4
        if _div(shape[b_dim], dp):
            spec[b_dim] = baxes
        if _div(shape[ndim - 2], size):
            spec[ndim - 2] = model_axis
        elif _div(shape[ndim - 1], size):
            spec[ndim - 1] = model_axis
    elif ndim > b_dim and _div(shape[b_dim], dp):
        spec[b_dim] = baxes
    return tuple(spec)


def _map_tree(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_tree(fn, v, names + (str(i),)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(names, tree)


def cache_specs(caches, mesh, model_axis: str = "model"):
    """Specs of a cache tree (nested dicts, lists and tuples of tensors;
    list and tuple positions are path digits), in the tree's structure."""
    return _map_tree(lambda names, t: cache_spec(names, tuple(t.shape), mesh,
                                                 model_axis), caches)


def cache_placements(caches, mesh, model_axis: str = "model"):
    """DTensor placements of a cache tree on ``mesh``, in its structure."""
    return _map_tree(lambda names, t: placements(
        cache_spec(names, tuple(t.shape), mesh, model_axis), mesh), caches)
