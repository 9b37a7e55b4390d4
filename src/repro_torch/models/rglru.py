"""RecurrentGemma / Griffin [arXiv:2402.19427]: RG-LRU recurrent blocks
interleaved 2:1 with local (sliding-window) attention, MQA. The port of
the JAX package's ``models/rglru.py``.

Recurrence (per channel):
    r_t = sigmoid(x_t W_a + b_a)                      (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)                      (input gate)
    log a_t = -c * softplus(Λ) * r_t                  (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t ⊙ x_t)

A prefill (or a forward without cache) runs the recurrence through the
hand-written scan kernel (:func:`repro_torch.kernels.ops.rglru_scan`,
which replaces both the JAX model's associative scan and its Pallas
kernel); a decode step with a state is one fused update
(:func:`rglru_step`).

Layer pattern: cfg.rglru.block_pattern (default (recurrent, recurrent,
attention)) cycled over cfg.num_layers. The model is one ``nn.Module``
whose ``blocks`` sit in layer order (the JAX package stacks whole pattern
periods for ``lax.scan``; :func:`jax_name` maps each layer to its period
and row).
Training reads the params as a flat dict in that JAX leaf structure
(:func:`stack_params`: ``periods.<j>.*`` stacked over the whole periods,
``rem.<j>.*`` the remainder layers); with ``cfg.remat`` a forward that
records gradients recomputes each whole period in the backward, as the
JAX package checkpoints its period function (the remainder layers are not
recomputed), so B3 and B4 run again for those layers.

On a data x model mesh (``tp``, :mod:`repro_torch.sharding.parallel`) a
recurrent block whose leaves the table splits on the RG-LRU width (the
remainder layers, unstacked) runs as one region: ``w_branch_x`` and
``w_branch_gate`` by column, ``w_a``/``w_x`` by block, ``b_a``, ``b_x``,
``lam`` by width, ``w_out`` by row; the replicated conv weight and bias
enter through *f* cut to this rank's width columns, so the scan kernel
runs on this rank's (B, T, W/m). The table puts the recurrent state
``h`` and the conv state on the batch dim only, whole width on every
rank: a serving step reads its width slice of each and all-gathers the
new state over the model group, so the state stays where the table puts
it, at (m − 1)/m · B·W·(4 + (w − 1)·e) bytes a layer and step received
per rank (e bytes an activation element, w the conv width). The period-stacked leaves the
table splits on d or on the period dim (its stack dim is not skipped
for ``periods.<j>`` paths) are gathered whole a layer at a time and
their blocks run whole on every rank (:meth:`~repro_torch.sharding.
parallel.TensorParallel.materialize`). The local attention serves from a
KV cache split on head_dim when its kv head does not divide the model
axis (:class:`~repro_torch.sharding.parallel.CacheSplit`).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding.parallel import Region, gather

RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------


def rglru_step(log_a, b, h_prev):
    """Single decode step: (B, W) each."""
    return torch.exp(log_a) * h_prev + b


class RGLRU(nn.Module):
    """Gate weights are BLOCK-DIAGONAL over cfg.num_heads blocks
    (``w_a``, ``w_x`` of shape (H, bw, bw)), as in the official
    RecurrentGemma implementation; Λ is drawn so that a ∈ [0.9, 0.999].
    The JAX package's ``init_rglru``."""

    def __init__(self, cfg, width: int, *, generator=None, device="cuda"):
        super().__init__()
        pd = L.dtype_of(cfg.param_dtype)
        H = cfg.num_heads
        bw = width // H
        u = torch.empty(width, dtype=torch.float32, device=device)
        u.uniform_(0.9 ** 2, 0.999 ** 2, generator=generator)
        lam = torch.log(torch.exp(-torch.log(u) / (2 * RGLRU_C)) - 1.0)
        kw = dict(generator=generator, dtype=pd, device=device)
        self.lam = L.param(lam.to(pd))
        self.w_a = L.param(L.dense_init((H, bw, bw), **kw))
        self.b_a = L.param(torch.zeros(width, dtype=pd, device=device))
        self.w_x = L.param(L.dense_init((H, bw, bw), **kw))
        self.b_x = L.param(torch.zeros(width, dtype=pd, device=device))


def _block_diag_gate(x, w, b):
    """x (B,T,W) with W split into H blocks; w (H, bw, bw)."""
    B, T, W = x.shape
    H, bw, _ = w.shape
    xb = x.reshape(B, T, H, bw)
    y = torch.einsum("bthk,hkj->bthj", xb, w)
    return y.reshape(B, T, W) + b


def rglru_apply(p, cfg, x, h0=None):
    """x: (B, T, W) -> (y, h_last). f32 recurrence internals."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(_block_diag_gate(xf, p.w_a.to(torch.float32),
                                       p.b_a.to(torch.float32)))
    i = torch.sigmoid(_block_diag_gate(xf, p.w_x.to(torch.float32),
                                       p.b_x.to(torch.float32)))
    log_a = -RGLRU_C * F.softplus(p.lam.to(torch.float32)) * r
    gated = i * xf
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * gated
    T = x.shape[1]
    if T == 1 and h0 is not None:
        h = rglru_step(log_a[:, 0], b[:, 0], h0)
        return h[:, None].to(x.dtype), h
    y, h_last = ops.rglru_scan(log_a, b, h0)
    return y.to(x.dtype), h_last


# ---------------------------------------------------------------------------
# causal conv1d (depthwise, width w) with decode state
# ---------------------------------------------------------------------------


class Conv1d(nn.Module):
    def __init__(self, width: int, kernel: int, pd, *, generator=None,
                 device="cuda"):
        super().__init__()
        w = torch.randn(kernel, width, generator=generator,
                        dtype=torch.float32, device=device)
        self.w = L.param((w / math.sqrt(kernel)).to(pd))
        self.b = L.param(torch.zeros(width, dtype=pd, device=device))


def conv1d_apply(p, x, state=None):
    """Depthwise causal conv. x (B,T,W); state (B, kernel-1, W) history.

    Returns (y, new_state).
    """
    kernel = p.w.shape[0]
    dt = x.dtype
    if state is None:
        state = torch.zeros(x.shape[0], kernel - 1, x.shape[2], dtype=dt,
                            device=x.device)
    xp = torch.cat([state.to(dt), x], dim=1)
    w = p.w.to(dt)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kernel))
    y = y + p.b.to(dt)
    new_state = xp[:, -(kernel - 1):] if kernel > 1 else state
    return y, new_state


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class RecurrentBlock(nn.Module):
    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        W = cfg.rglru.lru_width or cfg.d_model
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        d = cfg.d_model
        self.norm = L.param(torch.zeros(d, dtype=pd, device=device))
        self.w_branch_x = L.param(L.dense_init((d, W), dtype=pd, **kw))
        self.w_branch_gate = L.param(L.dense_init((d, W), dtype=pd, **kw))
        self.conv = Conv1d(W, cfg.rglru.conv1d_width, pd, **kw)
        self.rglru = RGLRU(cfg, W, **kw)
        self.w_out = L.param(L.dense_init((W, d), dtype=pd, **kw))
        self.mlp_norm = L.param(torch.zeros(d, dtype=pd, device=device))
        self.mlp = L.Mlp(cfg, **kw)


#: the dims a recurrent block's region splits its leaves on (any other
#: split is gathered whole first)
_KEEP_REC = {"w_branch_x": 1, "w_branch_gate": 1, "w_out": 0,
             "rglru.w_a": 0, "rglru.w_x": 0, "rglru.b_a": 0, "rglru.b_x": 0,
             "rglru.lam": 0}
_KEEP_MLP = {"mlp.w_gate": 1, "mlp.w_up": 1, "mlp.w_down": 0}
_KEEP_ATT = {"attn.wq": 1, "attn.wk": 1, "attn.wv": 1, "attn.wo": 0}


def _keep(bp, regions):
    """The dims each region of ``bp`` splits on, for the regions whose
    every leaf the table splits there (else none: gathered whole)."""
    keep = {}
    for region in regions:
        if all(bp._specs.get(k) == d for k, d in region.items()):
            keep.update(region)
    return keep


def recurrent_block(bp, cfg, x, state=None, tp=None):
    """Griffin recurrent block. state: {'conv': ..., 'h': ...} or None.
    ``tp``: the mesh's view (see the module docstring)."""
    dt = L.dtype_of(cfg.dtype)
    region, mlp_split, conv, cols = Region(), False, bp.conv, None
    if tp is not None:
        bp, left = tp.materialize(bp, bp._specs,
                                  _keep(bp, (_KEEP_REC, _KEEP_MLP)))
        mlp_split = "mlp.w_down" in left
        if "w_out" in left:
            region = Region(tp.group)
            n = bp.w_out.shape[0]
            cols = slice(tp.rank * n, (tp.rank + 1) * n)
            conv = SimpleNamespace(w=region.enter(bp.conv.w)[:, cols],
                                   b=region.enter(bp.conv.b)[cols])
            if state is not None:
                state = {"conv": state["conv"][..., cols],
                         "h": state["h"][:, cols]}
    h = region.enter(L.rms_norm(x, bp.norm, cfg.norm_eps))
    gate = F.gelu(h @ bp.w_branch_gate.to(dt), approximate="tanh")
    u = h @ bp.w_branch_x.to(dt)
    u, new_conv = conv1d_apply(conv, u,
                               None if state is None else state["conv"])
    y, h_last = rglru_apply(bp.rglru, cfg, u,
                            None if state is None else state["h"])
    x = x + region.reduce((y * gate) @ bp.w_out.to(dt))
    hh = L.rms_norm(x, bp.mlp_norm, cfg.norm_eps)
    mlp, mreg = ((bp.mlp, None) if tp is None
                 else tp.mlp_params(bp.mlp, mlp_split))
    x = x + L.mlp_block(mlp, cfg, hh, mreg)
    if cols is not None and state is not None:
        new_conv = gather(new_conv, tp.group, tp.model_size, -1)
        h_last = gather(h_last, tp.group, tp.model_size, -1)
    return x, {"conv": new_conv, "h": h_last}


class AttentionBlock(nn.Module):
    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        pd = L.dtype_of(cfg.param_dtype)
        self.norm = L.param(torch.zeros(cfg.d_model, dtype=pd, device=device))
        self.attn = L.Attention(cfg, generator=generator, device=device)
        self.mlp_norm = L.param(torch.zeros(cfg.d_model, dtype=pd,
                                            device=device))
        self.mlp = L.Mlp(cfg, generator=generator, device=device)


def attention_block(bp, cfg, x, positions, cache=None, cache_index=None,
                    tp=None):
    attn, region, csplit, mlp, mreg = bp.attn, Region(), None, bp.mlp, None
    if tp is not None:
        bp, left = tp.materialize(bp, bp._specs,
                                  _keep(bp, (_KEEP_ATT, _KEEP_MLP)))
        attn, region, csplit = tp.attention_params(
            bp.attn, cfg, split="attn.wo" in left,
            cache=None if cache is None else cache["k"])
        mlp, mreg = tp.mlp_params(bp.mlp, "mlp.w_down" in left)
    h = L.rms_norm(x, bp.norm, cfg.norm_eps)
    a, new_cache = L.attention_block(
        attn, cfg, region.enter(h), positions, window=cfg.sliding_window,
        cache=cache, cache_index=cache_index, split=csplit)
    x = x + region.reduce(a)
    hh = L.rms_norm(x, bp.mlp_norm, cfg.norm_eps)
    x = x + L.mlp_block(mlp, cfg, hh, mreg)
    return x, new_cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def layer_types(cfg):
    pat = cfg.rglru.block_pattern
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


class RecurrentGemma(nn.Module):
    """``embed`` (V, d), ``blocks`` in layer order, ``final_norm``,
    ``unembed`` (d, V)."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        if cfg.rglru is None:
            raise ValueError(f"{cfg.name} has no rglru settings")
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = L.param(L.dense_init((cfg.vocab_size, cfg.d_model),
                                          dtype=pd, scale=1.0, **kw))
        self.blocks = nn.ModuleList(
            RecurrentBlock(cfg, **kw) if t == "recurrent"
            else AttentionBlock(cfg, **kw) for t in layer_types(cfg))
        self.final_norm = L.param(torch.zeros(cfg.d_model, dtype=pd,
                                              device=device))
        self.unembed = L.param(L.dense_init((cfg.d_model, cfg.vocab_size),
                                            dtype=pd, **kw))
        self.block_pattern = tuple(cfg.rglru.block_pattern)


def init(cfg, *, generator=None, device="cuda") -> RecurrentGemma:
    """Random params drawn from ``generator`` on ``device``."""
    return RecurrentGemma(cfg, generator=generator, device=device)


def stack_params(model: RecurrentGemma) -> Dict[str, torch.Tensor]:
    """The module's params as a flat dict in the JAX leaf structure
    (:func:`jax_name`), detached."""
    return L.stack_layers(dict(model.named_parameters()),
                          lambda name: jax_name(model, name))


def jax_name(model: RecurrentGemma, name: str) -> tuple:
    """A param's JAX name and layer row: with P layers a pattern period
    and n_full whole periods, layer ``i·P + j`` (i < n_full) is row i of
    ``periods.<j>.<leaf>``, remainder layer ``n_full·P + j`` is
    ``rem.<j>.<leaf>``, the other params are as they are."""
    group, _, rest = name.partition(".")
    if group != "blocks":
        return name, None
    P = len(model.block_pattern)
    i, _, leaf = rest.partition(".")
    i, j = divmod(int(i), P)
    if i < len(model.blocks) // P:
        return f"periods.{j}.{leaf}", i
    return f"rem.{j}.{leaf}", None


def param_tree(params: Dict[str, torch.Tensor], cfg,
               tp=None) -> SimpleNamespace:
    """A :func:`stack_params` dict → the tree :func:`forward` reads, with
    ``blocks`` a list of per-layer namespaces (views ``t[i]`` of the
    periods) in layer order. With ``tp`` (this rank's shards) each layer
    carries ``_specs``, the table's split dim of each of its leaves, and
    the leaves split on the period dim are gathered whole first."""
    P = len(cfg.rglru.block_pattern)
    n_full = cfg.num_layers // P
    tree = L.namespace({k: v for k, v in params.items()
                        if k.partition(".")[0] not in ("periods", "rem")})
    blocks = [None] * cfg.num_layers
    for j in range(P if n_full else 0):
        prefix = f"periods.{j}."
        if tp is not None:
            params = tp.gather_stack_splits(params, prefix)
        for i, bp in enumerate(L.unstack_layers(params, f"periods.{j}",
                                                n_full, cfg)):
            if tp is not None:
                bp._specs = tp.layer_specs(prefix, True)
            blocks[i * P + j] = bp
    for j in range(cfg.num_layers - n_full * P):
        prefix = f"rem.{j}."
        bp = L.with_rope(L.namespace(
            {k[len(prefix):]: v for k, v in params.items()
             if k.startswith(prefix)}), cfg)
        if tp is not None:
            bp._specs = tp.layer_specs(prefix, False)
        blocks[n_full * P + j] = bp
    tree.blocks = blocks
    return tree


def _read_in_f32(name: str) -> bool:
    """The forward reads the norm weights and the RG-LRU's Λ and gates in
    f32; every other parameter only through a cast to ``cfg.dtype``."""
    return name.rsplit(".", 1)[-1].endswith("norm") or ".rglru." in name


def cast_for_serving(model: RecurrentGemma, cfg) -> RecurrentGemma:
    """Cast, once, every parameter the forward reads only through a cast
    to ``cfg.dtype``, replacing each tensor in place, so the f32 and the
    cast copy of a weight never both live beyond that one weight. The
    per-use casts then do nothing; the numbers are unchanged."""
    dt = L.dtype_of(cfg.dtype)
    for name, p in model.named_parameters():
        if not _read_in_f32(name):
            p.data = p.data.to(dt)
    return model


def init_cache(cfg, batch: int, seq_len: int, *, device="cuda"):
    """Per-layer state in layer order: attention layers get SWA kv caches,
    recurrent layers {'conv', 'h'} states."""
    W = cfg.rglru.lru_width or cfg.d_model
    dt = L.dtype_of(cfg.dtype)

    def one(t):
        if t == "attention":
            return L.init_kv_cache(cfg, batch, seq_len,
                                   window=cfg.sliding_window, device=device)
        return {"conv": torch.zeros(batch, cfg.rglru.conv1d_width - 1, W,
                                    dtype=dt, device=device),
                "h": torch.zeros(batch, W, dtype=torch.float32,
                                 device=device)}

    return [one(t) for t in layer_types(cfg)]


def _layer(t, bp, cfg, x, positions, state, cache_index, tp=None):
    if t == "recurrent":
        return recurrent_block(bp, cfg, x, state, tp)
    return attention_block(bp, cfg, x, positions, state, cache_index, tp)


def _period(blocks, cfg, x, positions, tp=None):
    """One whole pattern period without caches (the unit remat
    recomputes)."""
    for t, bp in zip(cfg.rglru.block_pattern, blocks):
        x, _ = _layer(t, bp, cfg, x, positions, None, None, tp)
    return x


def forward(model, cfg, tokens, *, positions=None, caches=None,
            cache_index: Optional[int] = None,
            embeddings: Optional[torch.Tensor] = None,
            last_only: bool = False, tp=None):
    """tokens (B, S) → (logits (B, S or 1, V) in cfg.dtype, new caches or
    None, aux 0.0). ``model`` is a :class:`RecurrentGemma` or a
    :func:`stack_params` dict. ``embeddings`` (B, S, d) bypasses the embed
    table. ``last_only`` unembeds only the last position (the same
    numbers as slicing ``logits[:, -1:]``). ``tp``: on a data x model
    mesh, ``model`` is this rank's shards of a :func:`stack_params` dict
    and ``caches`` its shards by the table (module docstring)."""
    if isinstance(model, dict):
        model = param_tree(model, cfg, tp)
    dt = L.dtype_of(cfg.dtype)
    if embeddings is not None:
        x = embeddings.to(dt)
    elif tp is not None:
        x = tp.embed(model.embed, tokens).to(dt)
    else:
        x = model.embed[tokens].to(dt)
    B, S, _ = x.shape
    if positions is None:
        positions = L.decode_positions(S, cache_index, x.device)
        positions = positions[None, :].expand(B, S)

    types = layer_types(cfg)
    start, new_caches = 0, []
    if cfg.remat and caches is None and torch.is_grad_enabled():
        P = len(cfg.rglru.block_pattern)
        for i in range(0, cfg.num_layers // P * P, P):
            x = checkpoint(_period, model.blocks[i:i + P], cfg, x, positions,
                           tp, use_reentrant=False)
            new_caches += [None] * P
        start = len(new_caches)
    for i in range(start, cfg.num_layers):
        st = None if caches is None else caches[i]
        x, ns = _layer(types[i], model.blocks[i], cfg, x, positions, st,
                       cache_index, tp)
        new_caches.append(ns)

    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    w_out = model.unembed.to(dt)
    logits = x @ w_out if tp is None else tp.unembed(x, w_out, False)
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.logit_softcap).to(dt)
    return logits, (None if caches is None else new_caches), 0.0
