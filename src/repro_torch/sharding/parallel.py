"""Tensor- and data-parallel regions of the transformer family on a data x
model ``DeviceMesh`` (Megatron-style column/row splits, placed by
:mod:`repro_torch.sharding.rules`).

Each process holds its LOCAL shard of every leaf as a plain tensor
(:func:`shard_params`: ``distribute_tensor`` then ``to_local``), so the
attention kernel, which launches on raw pointers, always receives this
rank's heads as plain tensors and never a DTensor. A region (attention,
MLP, MoE experts, the vocab-split embed and unembed) whose leaves the
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
collective. Data parallelism: each data rank holds its rows of the batch
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


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None,
                None, None)


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
    """Sum ``t`` in place over the mesh's data axes; returns it."""
    for a in data_axes(mesh):
        dist.all_reduce(t, group=mesh.get_group(a))
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
        return _GatherLast.apply(part, self.group, self.rank,
                                 self.model_size)

    # -- regions of a block ---------------------------------------------------
    def attention_params(self, p, cfg):
        """``p`` (a block's attention leaves, this rank's shards) as the
        attention block reads them: replicated leaves read inside the
        region through *f*, and an unsplit kv projection cut to the kv
        heads this rank's query heads read."""
        region = self.region("blocks.attn.wo")
        if region.group is None:
            return p, region
        view = SimpleNamespace(**vars(p))
        for name in ("q_norm", "k_norm"):
            if hasattr(p, name):
                setattr(view, name, region.enter(getattr(p, name)))
        if not self.split("blocks.attn.wk"):
            hl = p.wq.shape[1]                     # this rank's query heads
            g = cfg.num_heads // cfg.num_kv_heads  # query heads a kv head
            h0 = self.rank * hl
            for name in ("wk", "wv"):
                w = region.enter(getattr(p, name))
                if hl % g == 0:                    # whole kv groups
                    w = w[:, h0 // g:(h0 + hl) // g]
                elif g % hl == 0:                  # inside one kv group
                    w = w[:, h0 // g:h0 // g + 1]
                else:                              # one kv head a query
                    w = w.repeat_interleave(g, dim=1)[:, h0:h0 + hl]
                setattr(view, name, w)
        return view, region

    def mlp_region(self, p, name: str) -> Region:
        """The region of a gated MLP ``p`` whose ``w_down`` is the leaf
        ``name``."""
        if hasattr(p, "b_up"):
            raise ValueError(
                "the tensor-parallel forward covers gated MLPs (the "
                "transformer family's); a plain MLP's biases (whisper, "
                "xLSTM) wait for their families' tensor-parallel forward — "
                "run those without a mesh")
        return self.region(name)


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
