"""Mixture-of-Experts MLP (mixtral / qwen2-moe style): the port of the JAX
package's ``models/moe.py`` (``init_moe_mlp``, ``moe_block``).

Dispatch is capacity-based with scatter/gather routing: each token's top-k
assignments are scattered into an (E, cap, d) buffer at (expert,
position-in-expert), the expert MLPs run as batched products over the
stacked expert weights, and the results are gathered back and combined
with the router gates. The position of an assignment is the count of
earlier assignments to its expert in the token-major flattened (N·k)
order, so which assignments overflow ``cap`` and drop (they contribute
zero; the residual stream carries the token) is the JAX package's set.

The router and the shared expert's gate multiply in f32, as the JAX
package does; :func:`repro_torch.models.transformer.cast_for_serving`
keeps both in f32. On a data x model mesh (:func:`moe_block` given a
``tp``) each data shard routes its own tokens and the experts' f
dimension stays split over ``model`` (:mod:`repro_torch.sharding.
parallel`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.sharding.parallel import Region, TensorParallel, data_mean


class MoeMlp(nn.Module):
    """``router`` (d, E), expert stacks ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d); with shared experts, ``shared`` (one gated MLP
    of ``shared_expert_d_ff``) and ``shared_gate`` (d, 1)."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
        kw = dict(generator=generator, dtype=L.dtype_of(cfg.param_dtype),
                  device=device)
        self.router = L.param(L.dense_init((d, E), **kw))
        self.w_gate = L.param(L.dense_init((E, d, f), **kw))
        self.w_up = L.param(L.dense_init((E, d, f), **kw))
        self.w_down = L.param(L.dense_init((E, f, d), **kw))
        if m.num_shared_experts:
            self.shared = L.Mlp(cfg, d_ff=m.shared_expert_d_ff or f,
                                generator=generator, device=device)
            self.shared_gate = L.param(L.dense_init((d, 1), **kw))


class Routing(NamedTuple):
    """One batch's assignments, flattened token-major (row i·k + j is
    token i's j-th choice)."""

    gates: torch.Tensor     # (N, k) f32, softmax over the top-k logits
    experts: torch.Tensor   # (N·k,) int64 expert of each assignment
    pos: torch.Tensor       # (N·k,) int64 slot in its expert (0 if dropped)
    keep: torch.Tensor      # (N·k,) bool, within capacity
    cap: int
    aux: torch.Tensor       # () f32 Switch load-balancing loss


def expert_capacity(cfg, n_tokens: int) -> int:
    """Slots per expert: max(⌈k·N/E·capacity_factor⌉, 1)."""
    m = cfg.moe
    return max(int(math.ceil(m.top_k * n_tokens / m.num_experts
                             * m.capacity_factor)), 1)


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` as a bool mask, with no host read: on the CPU
    ``F.one_hot`` checks the indices' range by reading them (the card's
    does not), which would fail the capture probe there."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def route(p, cfg, xf, *, capacity: Optional[int] = None) -> Routing:
    """f32 router, top-k, the Switch aux loss and position-in-expert for
    tokens ``xf`` (N, d)."""
    m = cfg.moe
    N = xf.shape[0]
    E, k = m.num_experts, m.top_k
    logits = xf.to(torch.float32) @ p.router.to(torch.float32)   # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = torch.topk(logits, k, dim=-1)          # (N, k)
    gates = torch.softmax(gate_vals, dim=-1)                     # renorm

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    ce = _one_hot(topk_idx, E).to(torch.float32).sum(1).mean(0) / k
    aux = m.router_aux_loss_coef * E * torch.sum(me * ce)

    cap = capacity or expert_capacity(cfg, N)
    flat_e = topk_idx.reshape(-1)                                # (N·k,)
    # the running count of each expert along the assignments, scanned as
    # (E, N·k) rows: the card scans a contiguous last axis fast and the
    # (N·k, E) columns slowly (17.8 ms a layer at N·k = 65,536 on an H100)
    oh = _one_hot(flat_e, E).T.to(torch.int32).contiguous()     # (E, N·k)
    count = torch.cumsum(oh, dim=1, dtype=torch.int32)           # inclusive
    pos = count.gather(0, flat_e[None, :])[0].to(torch.int64) - 1
    keep = pos < cap
    pos = torch.where(keep, pos, 0)
    return Routing(gates, flat_e, pos, keep, cap, aux)


def dispatch(r: Routing, xf, k: int, E: int):
    """Scatter-add each assignment's token row into an (E, cap, d) buffer
    at (expert, pos); a dropped assignment adds its zeroed row to slot 0,
    as the JAX package does."""
    N, d = xf.shape
    xk = xf[:, None, :].expand(N, k, d).reshape(N * k, d)
    xk = xk * r.keep[:, None].to(xf.dtype)
    buf = torch.zeros(E, r.cap, d, dtype=xf.dtype, device=xf.device)
    return buf.index_put_((r.experts, r.pos), xk, accumulate=True)


def experts(p, cfg, buf):
    """The expert MLPs batched over E: (E, cap, d) -> (E, cap, d)."""
    dt = L.dtype_of(cfg.dtype)
    act = L.act_fn(cfg.act)
    hg = torch.bmm(buf, p.w_gate.to(dt))
    hu = torch.bmm(buf, p.w_up.to(dt))
    return torch.bmm(act(hg) * hu, p.w_down.to(dt))


def combine(r: Routing, ho, N: int, k: int):
    """Gather each assignment's expert output and sum a token's k outputs
    weighted by its gates (a dropped assignment weighs 0)."""
    yk = ho[r.experts, r.pos]                                   # (N·k, d)
    w = (r.gates.reshape(N * k) * r.keep.to(torch.float32)).to(ho.dtype)
    return (yk * w[:, None]).reshape(N, k, -1).sum(dim=1)


def moe_block(p, cfg, x, *, capacity: Optional[int] = None, tp=None):
    """x (B, S, d) -> (out (B, S, d) in cfg.dtype, aux_loss () f32).
    ``capacity`` overrides the slots per expert.

    ``tp``: the :class:`repro_torch.sharding.parallel.TensorParallel`
    view of a data x model mesh, ``x`` this data rank's rows and ``p``
    its f-split experts. The routing does not cross data shards (a global
    dispatch buffer is O(global tokens · d)): the rank routes its LOCAL
    tokens into a local (E, cap_local, d) buffer, the router and the
    gates read the whole tokens, the experts' partial outputs are summed
    over the model group, and the aux loss is averaged over the data
    axes, so every shard returns the same scalar
    (:func:`~repro_torch.sharding.parallel.data_mean`). A batch that does
    not divide the data axes is replicated by the table
    (:func:`repro_torch.sharding.rules.data_spec`): every shard then
    routes the whole batch, as the JAX package's plain-path fallback
    does, and the mean of the equal aux values is that value."""
    m = cfg.moe
    dt = L.dtype_of(cfg.dtype)
    x = x.to(dt)
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    r = route(p, cfg, xf, capacity=capacity)
    experts_tp = (Region() if tp is None
                  else tp.region("blocks.mlp.w_down"))
    r = r._replace(gates=experts_tp.enter(r.gates))
    ho = experts(p, cfg, dispatch(r, experts_tp.enter(xf), m.top_k,
                                  m.num_experts))
    y = experts_tp.reduce(combine(r, ho, N, m.top_k))
    if hasattr(p, "shared"):
        shared_tp = (Region() if tp is None
                     else tp.region("blocks.mlp.shared.w_down"))
        sg = torch.sigmoid(xf.to(torch.float32)
                           @ p.shared_gate.to(torch.float32))
        y = y + shared_tp.reduce(
            L.mlp_block(p.shared, cfg, shared_tp.enter(xf))
            * shared_tp.enter(sg.to(dt)))
    aux = r.aux
    if tp is not None and tp.data_axes:
        aux = data_mean(aux, tp.mesh)
    return y.reshape(B, S, d), aux


def moe_block_distributed(p, cfg, x, mesh, *, tp=None):
    """Per-data-shard MoE dispatch on ``mesh`` (the JAX package's name
    for its production path): :func:`moe_block` with ``tp``, or with
    every leaf whole on every rank when ``tp`` is None."""
    if tp is None:
        tp = TensorParallel(mesh)
    elif tp.mesh is not mesh:
        raise ValueError("moe_block_distributed: tp is the view of "
                         "another mesh")
    return moe_block(p, cfg, x, tp=tp)
