"""Decoder-only transformer (llama / granite / stablelm / deepseek / danube,
mixtral and qwen2-moe with a MoE MLP, and the chameleon VLM backbone,
whose early-fusion VQ tokens are ordinary ids): the port of the JAX
package's ``models/transformer.py``.

The JAX package stacks every block on a leading layer axis and scans it;
here ``blocks`` is a ``ModuleList`` in layer order
(:func:`jax_name` maps each param to its JAX leaf and row), and the
caches are a list of per-layer ``{"k", "v"}`` dicts: linear, or the
circular SWA window when ``sliding_window`` is shorter than the sequence.

Training reads the params as a flat dict in the JAX package's leaf
structure (:func:`stack_params`): ``embed``, ``final_norm``, ``unembed``
and one tensor per block leaf stacked on a leading layer axis
(``blocks.attn.wq`` (L, d, H, hd)); :func:`forward` takes such a dict
too and reads layer i as views ``stacked[name][i]``. With ``cfg.remat``
a forward that records gradients recomputes each block in the backward
(``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``), so
a training step runs the attention kernel 2·L times.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.sharding.parallel import Region


class Block(nn.Module):
    """``attn_norm``, ``attn``, ``mlp_norm`` and ``mlp`` (a gated or plain
    MLP, or the MoE MLP when ``cfg.moe`` is set)."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.attn_norm = L.param(torch.zeros(cfg.d_model, dtype=pd,
                                             device=device))
        self.attn = L.Attention(cfg, **kw)
        self.mlp_norm = L.param(torch.zeros(cfg.d_model, dtype=pd,
                                            device=device))
        self.mlp = moe.MoeMlp(cfg, **kw) if cfg.moe is not None \
            else L.Mlp(cfg, **kw)


class Transformer(nn.Module):
    """``embed`` (V, d), ``blocks`` in layer order, ``final_norm`` and,
    unless ``tie_embeddings``, ``unembed`` (d, V)."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = L.param(L.dense_init((cfg.vocab_size, cfg.d_model),
                                          dtype=pd, scale=1.0, **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.param(torch.zeros(cfg.d_model, dtype=pd,
                                              device=device))
        if not cfg.tie_embeddings:
            self.unembed = L.param(L.dense_init(
                (cfg.d_model, cfg.vocab_size), dtype=pd, **kw))


def init(cfg, *, generator=None, device="cuda") -> Transformer:
    """Random params drawn from ``generator`` on ``device``."""
    return Transformer(cfg, generator=generator, device=device)


def stack_params(model: Transformer) -> Dict[str, torch.Tensor]:
    """The module's params as a flat dict in the JAX package's leaf
    structure: ``blocks.<i>.<leaf>`` stacked into ``blocks.<leaf>`` (L,
    ...) in layer order, the other params as they are (detached)."""
    return L.stack_layers(dict(model.named_parameters()),
                          lambda name: jax_name(model, name))


def jax_name(model: Transformer, name: str) -> tuple:
    """A param's JAX name and layer row (:func:`layers.layer_row`)."""
    return L.layer_row(name, ("blocks",))


def param_tree(params: Dict[str, torch.Tensor], cfg) -> SimpleNamespace:
    """A :func:`stack_params` dict → the tree :func:`forward` reads, with
    ``blocks`` a list of per-layer namespaces of views ``t[i]``."""
    tree = L.namespace({k: v for k, v in params.items()
                        if not k.startswith("blocks.")})
    tree.blocks = L.unstack_layers(params, "blocks", cfg.num_layers, cfg)
    return tree


def _block_apply(bp, cfg, x, positions, cache, cache_index, tp=None):
    h = L.rms_norm(x, bp.attn_norm, cfg.norm_eps)
    attn, region, csplit = (
        (bp.attn, Region(), None) if tp is None
        else tp.attention_params(bp.attn, cfg,
                                 cache=None if cache is None else cache["k"]))
    a, new_cache = L.attention_block(
        attn, cfg, region.enter(h), positions, window=cfg.sliding_window,
        cache=cache, cache_index=cache_index, split=csplit)
    x = x + region.reduce(a)
    h = L.rms_norm(x, bp.mlp_norm, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe.moe_block(bp.mlp, cfg, h, tp=tp)
    else:
        region = (Region() if tp is None
                  else tp.region("blocks.mlp.w_down"))
        y = region.reduce(L.mlp_block(bp.mlp, cfg, region.enter(h)))
        aux = None
    return x + y, new_cache, aux


def forward(model: Transformer, cfg, tokens, *, positions=None, caches=None,
            cache_index: Optional[int] = None,
            embeddings: Optional[torch.Tensor] = None,
            last_only: bool = False, tp=None):
    """tokens (B, S) -> (logits (B, S or 1, V) in cfg.dtype, new caches or
    None, aux () f32: the summed MoE aux loss, 0 for a dense model).

    ``model`` is a :class:`Transformer` or a :func:`stack_params` dict.
    ``embeddings`` (B, S, d) bypasses the embed table (modality
    frontends). ``last_only`` unembeds only the last position (the same
    numbers as slicing ``logits[:, -1:]``).

    On a data x model mesh, ``model`` is this rank's shards of a
    :func:`stack_params` dict (:func:`repro_torch.sharding.parallel.
    shard_params`), ``tokens`` this rank's rows of the batch and ``tp``
    the :class:`~repro_torch.sharding.parallel.TensorParallel` view: each
    block runs its split regions between the model group's collectives,
    and the logits come back whole. When the mesh has a data axis the
    MoE routes per data shard (:func:`repro_torch.models.moe.moe_block`).
    A ``cfg.remat`` block is recomputed with the ``tp`` of its forward.
    Caches on the mesh are this rank's shards by the table
    (:func:`repro_torch.sharding.parallel.shard_cache`): its kv heads, or,
    when the kv heads do not divide the model axis, every kv head's
    head_dim slice (:class:`repro_torch.sharding.parallel.CacheSplit`)."""
    if isinstance(model, dict):
        model = param_tree(model, cfg)
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

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, bp in enumerate(model.blocks):
        if remat:
            x, nc, aux = checkpoint(_block_apply, bp, cfg, x, positions, None,
                                    None, tp, use_reentrant=False)
        else:
            x, nc, aux = _block_apply(bp, cfg, x, positions,
                                      None if caches is None else caches[i],
                                      cache_index, tp)
        if aux is not None:
            aux_total = aux_total + aux
        new_caches.append(nc)

    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    w_out = (model.embed.T if cfg.tie_embeddings else model.unembed).to(dt)
    logits = (x @ w_out if tp is None
              else tp.unembed(x, w_out, cfg.tie_embeddings))
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(
            logits.to(torch.float32) / cfg.logit_softcap).to(dt)
    return logits, (None if caches is None else new_caches), aux_total


def init_cache(cfg, batch: int, seq_len: int, *, device="cuda"):
    """Per-layer KV caches in layer order: length ``seq_len``, or the SWA
    window when it is shorter (circular)."""
    return [L.init_kv_cache(cfg, batch, seq_len, window=cfg.sliding_window,
                            device=device)
            for _ in range(cfg.num_layers)]


def _read_in_f32(name: str) -> bool:
    """The forward reads the norm weights (``*norm``: the block and final
    norms, ``q_norm``/``k_norm``), the MoE ``router`` and ``shared_gate``
    in f32; every other parameter only through a cast to ``cfg.dtype``."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf.endswith("norm") or leaf in ("router", "shared_gate")


def cast_for_serving(model: Transformer, cfg) -> Transformer:
    """Cast, once, every parameter the forward reads only through a cast
    to ``cfg.dtype``, replacing each tensor in place, so the f32 and the
    cast copy of a weight never both live beyond that one weight (peak
    memory stays the f32 model plus its largest tensor). The per-use casts
    then do nothing; the numbers are unchanged."""
    dt = L.dtype_of(cfg.dtype)
    for name, p in model.named_parameters():
        if not _read_in_f32(name):
            p.data = p.data.to(dt)
    return model
