"""Tensor- and data-parallel regions of every LM family on a data x model
``DeviceMesh`` (Megatron-style column/row splits, placed by
:mod:`repro_torch.sharding.rules`).

Each process holds its LOCAL shard of every leaf as a plain tensor
(:func:`shard_params`: ``distribute_tensor`` then ``to_local``), so the
attention kernel and the RG-LRU scan, which launch on raw pointers,
always receive this rank's heads or width as plain tensors and never a
DTensor. A region (attention, MLP, MoE experts, the RG-LRU block, the
vocab-split embed and unembed) whose leaves the
table split over ``model`` runs between two collectives over the model
group:

* ``enter`` (Megatron's *f*): the identity forward; the backward sums the
  gradient over the model group. Every replicated tensor read inside a
  region passes it (the block's input, the q/k norms, an unsplit kv
  projection, the MoE gates), so its gradient gathers every rank's part;
* ``reduce`` (*g*): the forward sums the ranks' partial outputs (a row
  split's partial sums); the backward is the identity.

The unembedding gathers the vocab shards of the logits (the backward
takes back this rank's columns). A region whose leaves the table left
replicated (the divisibility fallback) runs whole on every rank with no
collective.

A leaf the table splits on a dim the region does not split on (the
hybrid's period-stacked leaves, whose stack dim the table does not skip:
``w_branch_x`` on d, ``w_out`` on the period; the mLSTM's ``w_up``,
``w_gate`` and ``w_down``, which the table splits by their MLP names
while the mLSTM cell reads whole rows) is gathered whole before its
block runs (:meth:`TensorParallel.materialize`, one layer's row at a
time, inside a ``remat`` block's recompute; a split on the stack dim
itself is gathered once a forward), and the block then runs whole on
every rank: the same computation on every rank, so each rank's gradient
of the gathered leaf is the whole leaf's and the gather's backward keeps
this rank's chunk.

Serving from a KV cache the table splits on head_dim (kv heads that do
not divide the model axis): :class:`CacheSplit`.

Data parallelism: each data rank holds its rows of the batch
(:func:`repro_torch.data.pipeline.sharded_batch`), the MoE routes its
local tokens and averages its aux over the data axes
(:func:`repro_torch.models.moe.moe_block` given a ``tp``), and the train
step sums the gradients over the data axes
(:func:`repro_torch.launch.steps.make_train_step` given a mesh).

The mesh reaches the layers one way: the :class:`TensorParallel` view
``tp`` that the forward takes (the JAX package's layers read a
thread-local mesh instead; here a recomputed block under ``cfg.remat``
captures ``tp`` with its other arguments, so it takes the path its
forward took).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.optim import global_norm
from repro_torch.sharding import rules
from repro_torch.sharding.context import data_axes, mesh_shape


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's chunk (the
    gathered tensor feeds computation replicated on every rank, so every
    rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.rank, ctx.size, ctx.dim = rank, size, dim
        return gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.size, dim=ctx.dim)[ctx.rank].contiguous(), None,
                None, None, None)


def gather(x, group, size: int, dim: int):
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    autograd)."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def kv_cut(t, dim: int, h0: int, hl: int, g: int):
    """The kv heads (along ``dim``) that query heads [h0, h0 + hl) read,
    g query heads a kv head: whole kv groups, the one group they sit in,
    or one kv head a query head."""
    idx = [slice(None)] * t.ndim
    if hl % g == 0:
        idx[dim] = slice(h0 // g, (h0 + hl) // g)
    elif g % hl == 0:
        idx[dim] = slice(h0 // g, h0 // g + 1)
    else:
        t = t.repeat_interleave(g, dim=dim)
        idx[dim] = slice(h0, h0 + hl)
    return t[tuple(idx)]


class CacheSplit:
    """A KV cache the table splits on head_dim over the model group (kv
    heads that do not divide the model axis): every rank holds every kv
    head's ``[r·hd/m, (r+1)·hd/m)`` slice of head_dim.

    The kv projection is whole on every rank. A prefill launches the
    attention kernel on this rank's query heads (``q_heads``: (h0, hl),
    or None when the query heads are whole on every rank too) with the
    kv heads they read (:func:`kv_cut`) and stores the head_dim slice of
    every kv head (:meth:`store`). A decode step (:meth:`decode`) reads
    the split cache exactly:

    1. all-gather q over the model group (B, 1, H, hd), unless the query
       heads are whole already;
    2. partial scores q[..., slice] · k_sliceᵀ for every head, summed
       over the group by an all-reduce (B, K, g, 1, C) f32;
    3. the plain version's softcap, masks and softmax on the summed
       scores, then the partial p · v_slice (B, 1, H, hd/m);
    4. all-gather over head_dim, keeping the heads this rank's ``wo``
       rows read.

    Collective bytes a layer and decode step, per rank: the q gather
    (m − 1)/m · B·H·hd·e when the query heads are split (e bytes an
    element of the activations), the score all-reduce B·H·C·4 (C the
    cache length), and the output gather B·H·hd·e. Against gathering the
    cache (B·C·K·hd·e a step), the scores are the smaller whenever
    H·4 < K·hd·e.

    When head_dim does not divide the model axis either (danube: 8 kv
    heads, head_dim 120, on 16), the table replicates the cache: every
    rank stores every kv head whole (``whole``) and a decode step reads
    the kv heads its query heads need, with no collective."""

    def __init__(self, group, rank: int, size: int, cfg,
                 q_heads=None):
        self.group, self.rank, self.size = group, rank, size
        hd = cfg.head_dim_
        self.whole = hd % size != 0
        self.sl = (slice(None) if self.whole
                   else slice(rank * hd // size, (rank + 1) * hd // size))
        self.q_heads = q_heads
        self.g = cfg.num_heads // cfg.num_kv_heads

    def for_kernel(self, t):
        """Activations of every kv head (B, S, K, hd) → the kv heads this
        rank's query heads read."""
        if self.q_heads is None:
            return t
        return kv_cut(t, 2, self.q_heads[0], self.q_heads[1], self.g)

    def store(self, t):
        """(…, K, hd) → this rank's head_dim slice (…, K, hd/m)."""
        return t[..., self.sl]

    def decode(self, q, ck, cv, *, causal: bool, window: int, q_offset: int,
               softcap: float, k_len):
        """q (B, 1, hl, hd) of this rank's query heads against the split
        cache ck, cv (B, C, K, hd/m) → (B, 1, hl, hd), the numbers of
        :func:`repro_torch.kernels.ref.attention_reference` on the whole
        cache up to the order of the head_dim sums."""
        from repro_torch.kernels.ref import (NEG_INF, _mask_bias,
                                             attention_reference)

        if self.whole:
            return attention_reference(
                q, self.for_kernel(ck), self.for_kernel(cv), causal=causal,
                window=window, q_offset=q_offset, softcap=softcap,
                k_len=k_len)
        if self.q_heads is not None:
            q = gather(q, self.group, self.size, 2)
        B, S, H, hd = q.shape
        T, K = ck.shape[1], ck.shape[2]
        g = H // K
        acc = torch.promote_types(q.dtype, torch.float32)
        qf = (q.to(acc) / math.sqrt(hd)).to(q.dtype)
        qf = qf[..., self.sl].reshape(B, S, K, g, -1)
        scores = torch.einsum("bskgh,btkh->bkgst", qf.to(acc), ck.to(acc))
        dist.all_reduce(scores, group=self.group)
        if softcap > 0:
            scores = softcap * torch.tanh(scores / softcap)
        q_pos = q_offset + torch.arange(S, device=q.device)
        k_pos = torch.arange(T, device=q.device)
        scores = scores + _mask_bias(q_pos, k_pos, causal, window)
        if k_len is not None:
            valid = k_pos[None, :] < k_len[:, None]
            scores = torch.where(valid[:, None, None, None, :], scores,
                                 NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgst,btkh->bskgh", probs.to(cv.dtype).to(acc),
                           cv.to(acc)).reshape(B, S, H, -1).to(q.dtype)
        out = gather(out, self.group, self.size, 3)
        if self.q_heads is not None:
            h0, hl = self.q_heads
            out = out[:, :, h0:h0 + hl]
        return out


class Region:
    """*f* and *g* of one region over ``group`` (the identity when the
    region's leaves are not split: ``group`` None)."""

    def __init__(self, group=None):
        self.group = group

    def enter(self, x):
        return x if self.group is None else _Enter.apply(x, self.group)

    def reduce(self, x):
        return x if self.group is None else _Reduce.apply(x, self.group)


def sum_over_data(t, mesh):
    """Sum ``t`` in place over the mesh's data axes; returns it. A
    non-contiguous ``t`` (a gradient that is a view of a larger one: the
    sLSTM's four recurrent weights are read through one ``cat``) is
    summed in a contiguous copy and written back: a collective writes a
    tensor's storage span, which such a view shares with its siblings."""
    axes = data_axes(mesh)
    buf = t if not axes or t.is_contiguous() else t.contiguous()
    for a in axes:
        dist.all_reduce(buf, group=mesh.get_group(a))
    if buf is not t:
        t.copy_(buf)
    return t


def data_mean(x, mesh):
    """The mean of ``x`` over the mesh's data axes (the JAX package's
    ``pmean`` per axis) in the forward, while the backward passes the
    gradient to this rank's own ``x`` unscaled: each data rank then
    weighs its term as the caller's loss does (the train step divides by
    the data-parallel size and sums the gradients over the data axes)."""
    if not isinstance(x, torch.Tensor) or mesh is None:
        return x
    total = sum_over_data(x.detach().clone(), mesh)
    return x + (total / rules.dp_size(mesh) - x).detach()


class TensorParallel:
    """A forward's view of a data x model mesh: the model group, this
    rank's place in it, the data axes and their size ``dp``, and the
    table's spec of every leaf (``specs``, by JAX leaf name,
    :func:`repro_torch.sharding.rules.param_specs`; None: every leaf
    whole on every rank)."""

    def __init__(self, mesh, specs: Optional[Dict[str, tuple]] = None):
        self.mesh = mesh
        self.specs = specs
        size = mesh_shape(mesh).get("model", 1)
        self.model_size = size
        self.group = mesh.get_group("model") if size > 1 else None
        self.rank = mesh.get_local_rank("model") if size > 1 else 0
        self.data_axes = data_axes(mesh)
        self.dp = rules.dp_size(mesh)

    def split(self, name: str) -> bool:
        return self.specs is not None and "model" in self.specs[name]

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole model's gradient from this rank's
        shards ``grads`` (each summed over the data axes): the split
        leaves' squares summed over the model group."""
        if self.group is None:
            return global_norm(grads)
        dev = next(iter(grads.values())).device
        sq = [torch.zeros((), device=dev), torch.zeros((), device=dev)]
        for k, g in grads.items():
            sq[self.split(k)] += torch.sum(torch.square(g.to(torch.float32)))
        dist.all_reduce(sq[1], group=self.group)
        return torch.sqrt(sq[0] + sq[1])

    def region(self, name: str) -> Region:
        return Region(self.group if self.split(name) else None)

    # -- embeddings -----------------------------------------------------------
    def embed(self, table, tokens):
        """Rows of the (vocab-split) embedding table for ``tokens``."""
        if self.group is None or not self.split("embed"):
            return table[tokens]
        n = table.shape[0]
        ids = tokens - self.rank * n
        ok = (ids >= 0) & (ids < n)
        rows = table[torch.where(ok, ids, 0)] * ok[..., None].to(table.dtype)
        return Region(self.group).reduce(rows)

    def unembed(self, x, w_out, tied: bool):
        """Logits over the whole vocabulary from the (vocab-split)
        unembedding ``w_out`` (d, V_local)."""
        if self.group is None or not self.split("embed" if tied
                                                else "unembed"):
            return x @ w_out
        part = Region(self.group).enter(x) @ w_out
        return _Gather.apply(part, self.group, self.rank, self.model_size,
                             part.ndim - 1)

    # -- regions of a block ---------------------------------------------------
    def attention_params(self, p, cfg, split: Optional[bool] = None,
                         cache=None):
        """(``p`` (a block's attention leaves, this rank's shards) as the
        attention block reads them, the region, the :class:`CacheSplit`
        or None): replicated leaves read inside the region through *f*,
        and an unsplit kv projection cut to the kv heads this rank's query
        heads read. ``split``: whether the heads are split (default: the
        transformer's ``blocks.attn.wo``). ``cache``: a KV cache leaf of
        the layer (serving); when the table puts it on head_dim the kv
        projection stays whole and the :class:`CacheSplit` reads it."""
        if split is None:
            split = self.split("blocks.attn.wo")
        region = Region(self.group if split else None)
        csplit = (None if cache is None
                  else self.cache_split(cfg, p.wq.shape[1] if split else 0))
        if region.group is None:
            return p, region, csplit
        view = SimpleNamespace(**vars(p))
        for name in ("q_norm", "k_norm"):
            if hasattr(p, name):
                setattr(view, name, region.enter(getattr(p, name)))
        if p.wk.shape[1] == cfg.num_kv_heads:     # kv projection unsplit
            hl = p.wq.shape[1]                     # this rank's query heads
            g = cfg.num_heads // cfg.num_kv_heads  # query heads a kv head
            for name in ("wk", "wv"):
                w = region.enter(getattr(p, name))
                if csplit is None:
                    w = kv_cut(w, 1, self.rank * hl, hl, g)
                setattr(view, name, w)
        return view, region, csplit

    def cache_split(self, cfg, hl: int = 0) -> Optional[CacheSplit]:
        """The :class:`CacheSplit` of a serving step's KV caches when the
        table puts them on head_dim or replicates them (kv heads that do
        not divide the model axis), else None; ``hl``: this rank's query heads when they
        are split (0: whole on every rank)."""
        if self.group is None or cfg.num_kv_heads % self.model_size == 0:
            return None
        return CacheSplit(self.group, self.rank, self.model_size, cfg,
                          (self.rank * hl, hl) if hl else None)

    def mlp_params(self, p, split: bool):
        """(``p`` as the MLP region reads it, the region): a plain MLP's
        replicated ``b_up`` enters through *f* cut to this rank's columns
        when the region is split (``split``)."""
        region = Region(self.group if split else None)
        if region.group is None or not hasattr(p, "b_up"):
            return p, region
        view = SimpleNamespace(**vars(p))
        f = p.w_up.shape[-1]
        view.b_up = region.enter(p.b_up).narrow(0, self.rank * f, f)
        return view, region

    # -- leaves split on a dim their block does not split on ------------------
    def layer_specs(self, prefix: str, stacked: bool) -> Dict[str, object]:
        """``{leaf path under prefix: dim}`` of every leaf under ``prefix``
        the table splits: the split dim within one layer's row when
        ``stacked`` (``"stack"`` when the split is the stack dim itself),
        else within the leaf."""
        out = {}
        if self.group is None:         # a model axis of 1 splits nothing
            return out
        for name, spec in (self.specs or {}).items():
            if not name.startswith(prefix) or "model" not in spec:
                continue
            d = spec.index("model") - (1 if stacked else 0)
            out[name[len(prefix):]] = "stack" if d < 0 else d
        return out

    def gather_stack_splits(self, params: Dict[str, torch.Tensor],
                            prefix: str) -> Dict[str, torch.Tensor]:
        """``params`` with every leaf under ``prefix`` that the table
        splits on its stack dim gathered whole (once a forward)."""
        out = dict(params)
        for path, d in self.layer_specs(prefix, True).items():
            if d == "stack":
                name = prefix + path
                out[name] = _Gather.apply(params[name], self.group,
                                          self.rank, self.model_size, 0)
        return out

    def materialize(self, bp, specs: Dict[str, object],
                    keep: Dict[str, int]):
        """A layer namespace ``bp`` whose split leaves (``specs``, from
        :meth:`layer_specs`) are gathered whole where the block does not
        split them on that dim (``keep``: leaf path → the dim the block
        splits it on). Returns (the view, ``{path: dim}`` of the leaves
        left split)."""
        left = {}
        view = _copy_tree(bp)
        for path, d in specs.items():
            if d == "stack":
                continue
            if keep.get(path) == d:
                left[path] = d
                continue
            owner, _, leaf = path.rpartition(".")
            node = view
            for part in filter(None, owner.split(".")):
                node = getattr(node, part)
            setattr(node, leaf, _Gather.apply(getattr(node, leaf),
                                              self.group, self.rank,
                                              self.model_size, d))
        return view, left


def _copy_tree(ns):
    """A copy of a namespace tree (tensors shared)."""
    if not isinstance(ns, SimpleNamespace):
        return ns
    return SimpleNamespace(**{k: _copy_tree(v) for k, v in vars(ns).items()})


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of this rank's shard of a leaf of ``shape`` placed by
    ``spec`` (every split divides: the table splits only then)."""
    sizes = mesh_shape(mesh)
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        for a in axes:
            n //= sizes.get(a, 1)
        out.append(n)
    return tuple(out)


def shard_cache(caches, mesh, cfg=None):
    """This rank's slice, on the model axis, of every leaf of a cache
    tree allocated at the rank's batch rows (``init_cache`` with the
    local batch): the kv leaves on their kv-head dim, or on head_dim when
    the table puts them there."""
    r = mesh.get_local_rank("model") if "model" in mesh_shape(mesh) else 0
    m = mesh_shape(mesh).get("model", 1)

    def cut(names, t):
        spec = rules.cache_spec(names, tuple(t.shape), mesh)
        for d, e in enumerate(spec):
            if e == "model":
                n = t.shape[d] // m
                t = t.narrow(d, r * n, n).clone()
        return t
    return rules._map_tree(cut, caches)


def shard_params(params: Dict[str, torch.Tensor], cfg, mesh):
    """(this rank's shard of every leaf of a ``stack_params`` dict, the
    specs): each leaf is placed by the table with ``distribute_tensor``
    (every rank holds the same full leaf, so nothing is sent) and taken
    back as a plain local tensor."""
    from torch.distributed.tensor import distribute_tensor

    specs = rules.param_specs(params, cfg, mesh)
    local = {}
    for name, t in params.items():
        dt = distribute_tensor(t.detach(), mesh,
                               rules.placements(specs[name], mesh),
                               src_data_rank=None)
        local[name] = dt.to_local()
    return local, specs


def gather_params(local: Dict[str, torch.Tensor], specs: Dict[str, tuple],
                  mesh) -> Dict[str, torch.Tensor]:
    """Full leaves from every rank's shards (``DTensor.from_local`` then
    ``full_tensor``): what one process would hold."""
    from torch.distributed.tensor import DTensor

    return {name: DTensor.from_local(
        t, mesh, rules.placements(specs[name], mesh),
        run_check=False).full_tensor() for name, t in local.items()}
