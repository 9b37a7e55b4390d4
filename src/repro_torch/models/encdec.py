"""Whisper-style encoder-decoder transformer [arXiv:2212.04356]: the port
of the JAX package's ``models/encdec.py``.

The mel-spectrogram + conv feature extractor is the stubbed modality
frontend (:mod:`repro_torch.models.frontend`): the encoder consumes
precomputed frame embeddings (B, encoder_seq_len, d_model) passed as
``embeddings``. Positions are sinusoidal on both stacks (the JAX package
uses sinusoids on the decoder too, instead of whisper's learned
448-entry table; decoder positions are taken mod 448).

Layers use LayerNorm and the plain (biased) MLP, as whisper does; the
attention projections are the shared module's (``num_kv_heads ==
num_heads``). The encoder's self-attention is unmasked and the decoder's
cross-attention reads the encoder's states: both go to the flash-attention
kernel with ``causal=False`` (the JAX package's ``attention_reference``
there), as does the decoder's causal self-attention over a fresh
sequence. A decode step attends over its caches with the plain version.

The JAX package stacks both block stacks on a leading layer axis and
scans them; here ``enc_blocks`` and ``dec_blocks`` are ``ModuleList``s in
layer order, and the caches are ``{"self": [per-layer {"k", "v"}],
"cross": [per-layer {"k", "v"}]}``. Training reads the params as a flat
dict in the JAX leaf structure (:func:`stack_params`: ``enc_blocks.*``
(L_enc, ...) and ``dec_blocks.*`` (L_dec, ...) stacked, 35 leaves); with
``cfg.remat`` a forward that records gradients recomputes each encoder and
decoder block in the backward (``torch.utils.checkpoint``), so a training
step runs the attention kernel twice per attention.

On a data x model mesh (``tp``, :mod:`repro_torch.sharding.parallel`)
the attention heads split where their count divides the model axis
(self, cross and the encoder's, each a region), the plain MLP splits
``w_up`` by column with ``b_up`` cut to the rank's columns through *f*
and ``w_down`` by row with ``b_down`` added once after *g*, the
LayerNorms run on the replicated stream before each region's *f*, and
the tied embedding splits over the vocabulary. The cross K/V of a split
layer are this rank's heads. When the heads do not divide the model
axis (20 heads on 16) the attention runs whole on every rank and the
table puts the self and cross caches on head_dim: a prefill stores every
head's head_dim slice and a decode step reads them through
:class:`~repro_torch.sharding.parallel.CacheSplit`.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding.parallel import Region

#: the stacked layer groups of the JAX leaf structure
GROUPS = ("enc_blocks", "dec_blocks")


def sinusoids(length: int, channels: int) -> np.ndarray:
    """(length, channels) f32 table: sin then cos of position × 10000^(-j
    / (channels/2 − 1)), computed in f64 as the JAX package does."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


_TABLES: dict = {}


def sinusoid_table(length: int, channels: int, device) -> torch.Tensor:
    """:func:`sinusoids` on ``device``, copied there once per (length,
    channels, device)."""
    key = (length, channels, str(torch.device(device)))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(sinusoids(length, channels)).to(device)
    return _TABLES[key]


class LayerNorm(nn.Module):
    """``w`` (ones) and ``b`` (zeros) of width d."""

    def __init__(self, cfg, *, device="cuda"):
        super().__init__()
        pd = L.dtype_of(cfg.param_dtype)
        self.w = L.param(torch.ones(cfg.d_model, dtype=pd, device=device))
        self.b = L.param(torch.zeros(cfg.d_model, dtype=pd, device=device))


def _ln(p, cfg, x):
    return L.layer_norm(x, p.w, p.b, cfg.norm_eps)


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = LayerNorm(cfg, device=device)
        self.attn = L.Attention(cfg, **kw)
        self.ln2 = LayerNorm(cfg, device=device)
        self.mlp = L.Mlp(cfg, **kw)


class DecBlock(nn.Module):
    """``ln1``, ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``mlp``."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln1 = LayerNorm(cfg, device=device)
        self.self_attn = L.Attention(cfg, **kw)
        self.ln2 = LayerNorm(cfg, device=device)
        self.cross_attn = L.Attention(cfg, **kw)
        self.ln3 = LayerNorm(cfg, device=device)
        self.mlp = L.Mlp(cfg, **kw)


class EncDec(nn.Module):
    """``enc_blocks``, ``enc_norm``, ``embed`` (V, d; the logits are tied
    to it), ``dec_blocks``, ``dec_norm``."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        if cfg.encdec is None:
            raise ValueError(f"{cfg.name} has no encdec settings")
        pd = L.dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, **kw) for _ in range(cfg.encdec.num_encoder_layers))
        self.enc_norm = LayerNorm(cfg, device=device)
        self.embed = L.param(L.dense_init((cfg.vocab_size, cfg.d_model),
                                          dtype=pd, scale=1.0, **kw))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, **kw)
                                        for _ in range(cfg.num_layers))
        self.dec_norm = LayerNorm(cfg, device=device)


def init(cfg, *, generator=None, device="cuda") -> EncDec:
    """Random params drawn from ``generator`` on ``device``."""
    return EncDec(cfg, generator=generator, device=device)


def stack_params(model: EncDec) -> Dict[str, torch.Tensor]:
    """The module's params as a flat dict in the JAX leaf structure:
    ``enc_blocks.<leaf>`` (L_enc, ...) and ``dec_blocks.<leaf>`` (L_dec,
    ...) stacked in layer order, the other params as they are."""
    return L.stack_layers(dict(model.named_parameters()),
                          lambda name: jax_name(model, name))


def jax_name(model: EncDec, name: str) -> tuple:
    """A param's JAX name and layer row (:func:`layers.layer_row`)."""
    return L.layer_row(name, GROUPS)


def param_tree(params: Dict[str, torch.Tensor], cfg) -> SimpleNamespace:
    """A :func:`stack_params` dict → the tree :func:`forward` reads."""
    tree = L.namespace({k: v for k, v in params.items()
                        if k.partition(".")[0] not in GROUPS})
    tree.enc_blocks = L.unstack_layers(params, "enc_blocks",
                                       cfg.encdec.num_encoder_layers)
    tree.dec_blocks = L.unstack_layers(params, "dec_blocks", cfg.num_layers)
    return tree


def _mlp(tp, group, p, cfg, h):
    """The block group's plain MLP on ``h``, a region on the mesh ``tp``
    (b_up cut to the rank's columns, b_down added after *g*)."""
    view, region = ((p, None) if tp is None else
                    tp.mlp_params(p, tp.split(f"{group}.mlp.w_down")))
    return L.mlp_block(view, cfg, h, region)


def _enc_block(bp, cfg, x, tp=None):
    dt = L.dtype_of(cfg.dtype)
    region = Region() if tp is None else tp.region("enc_blocks.attn.wo")
    h = region.enter(_ln(bp.ln1, cfg, x))
    q, k, v = (L.heads_in(h, w.to(dt))
               for w in (bp.attn.wq, bp.attn.wk, bp.attn.wv))
    out = ops.flash_attention(q, k, v, causal=False)
    wo = bp.attn.wo.to(dt)
    x = x + region.reduce(out.flatten(-2) @ wo.reshape(-1, wo.shape[-1]))
    h = _ln(bp.ln2, cfg, x)
    return x + _mlp(tp, "enc_blocks", bp.mlp, cfg, h)


def _remat(cfg) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def encode(params, cfg, frames, tp=None):
    """frames (B, T_enc, d) stub embeddings → encoder states (B, T_enc,
    d) in ``cfg.dtype`` (whole on every rank of a mesh ``tp``)."""
    dt = L.dtype_of(cfg.dtype)
    T = frames.shape[1]
    x = frames.to(dt) + sinusoid_table(T, cfg.d_model,
                                       frames.device).to(dt)[None]
    for bp in params.enc_blocks:
        x = (checkpoint(_enc_block, bp, cfg, x, tp, use_reentrant=False)
             if _remat(cfg) else _enc_block(bp, cfg, x, tp))
    return _ln(params.enc_norm, cfg, x)


def compute_cross_kv(params, cfg, enc_out, tp=None):
    """Per-decoder-layer cross K/V from the encoder states: a list of
    ``{"k", "v"}`` (B, T_enc, H, hd), this rank's heads on a mesh ``tp``
    whose model axis splits them (the states enter the cross-attention
    region through *f*)."""
    dt = L.dtype_of(cfg.dtype)
    region = (Region() if tp is None
              else tp.region("dec_blocks.cross_attn.wo"))
    out = []
    for bp in params.dec_blocks:
        e = region.enter(enc_out)
        out.append({"k": L.heads_in(e, bp.cross_attn.wk.to(dt)),
                    "v": L.heads_in(e, bp.cross_attn.wv.to(dt))})
    return out


def _attention(tp, p, cfg, name, cache):
    """(p as the attention reads it, its region, the cache split) of the
    attention ``name`` on the mesh ``tp``."""
    if tp is None:
        return p, Region(), None
    return tp.attention_params(p, cfg, split=tp.split(f"{name}.wo"),
                               cache=cache)


def _dec_block(bp, cfg, x, positions, cross, cache, cache_index, tp=None,
               serving=False):
    attn, region, csplit = _attention(tp, bp.self_attn, cfg,
                                      "dec_blocks.self_attn",
                                      None if cache is None else cache["k"])
    h = region.enter(_ln(bp.ln1, cfg, x))
    a, new_cache = L.attention_block(attn, cfg, h, positions, cache=cache,
                                     cache_index=cache_index, split=csplit)
    x = x + region.reduce(a)
    attn, region, csplit = _attention(tp, bp.cross_attn, cfg,
                                      "dec_blocks.cross_attn",
                                      cross["k"] if serving else None)
    h = region.enter(_ln(bp.ln2, cfg, x))
    a, _ = L.attention_block(attn, cfg, h, positions,
                             cross_kv=(cross["k"], cross["v"]), split=csplit)
    x = x + region.reduce(a)
    h = _ln(bp.ln3, cfg, x)
    return x + _mlp(tp, "dec_blocks", bp.mlp, cfg, h), new_cache


def forward(params, cfg, tokens, *, positions=None, caches=None,
            cache_index: Optional[int] = None,
            embeddings: Optional[torch.Tensor] = None,
            last_only: bool = False, tp=None):
    """tokens (B, S) → (logits (B, S or 1, V) in cfg.dtype, new caches or
    None, aux 0 f32).

    ``params`` is an :class:`EncDec` or a :func:`stack_params` dict.
    ``embeddings``: the encoder's frames (train, prefill: the encoder
    runs and its cross K/V go into the caches), or None (a decode step:
    the cross K/V must already be in ``caches``). ``caches`` None: teacher
    forcing, no self cache. ``last_only`` unembeds only the last position
    (the same numbers as slicing ``logits[:, -1:]``). ``tp``: on a data x
    model mesh, ``params`` is this rank's shards of a
    :func:`stack_params` dict and ``caches`` its shards by the table
    (module docstring)."""
    if isinstance(params, dict):
        params = param_tree(params, cfg)
    dt = L.dtype_of(cfg.dtype)
    B, S = tokens.shape
    csplit = None
    if tp is not None and caches is not None:
        csplit = tp.cache_split(
            cfg, params.dec_blocks[0].cross_attn.wq.shape[1]
            if tp.split("dec_blocks.cross_attn.wo") else 0)
    if embeddings is not None:
        cross = compute_cross_kv(params, cfg,
                                 encode(params, cfg, embeddings, tp), tp)
    elif caches is not None and caches.get("cross") is not None:
        cross = caches["cross"]
    else:
        raise ValueError(
            f"{cfg.name}: the decoder needs the encoder's frames "
            "(embeddings=, from repro_torch.models.frontend) or caches "
            "holding the cross K/V of an earlier prefill")

    x = (params.embed[tokens] if tp is None
         else tp.embed(params.embed, tokens)).to(dt)
    if positions is None:
        positions = L.decode_positions(S, cache_index, x.device)
        positions = positions[None, :].expand(B, S)
    table = sinusoid_table(max(cfg.encdec.max_decoder_ctx, 1), cfg.d_model,
                           x.device)
    x = x + table[positions % table.shape[0]].to(dt)

    self_caches = None if caches is None else caches["self"]
    remat = _remat(cfg) and caches is None
    new_self = []
    for i, bp in enumerate(params.dec_blocks):
        if remat:
            x, nc = checkpoint(_dec_block, bp, cfg, x, positions, cross[i],
                               None, None, tp, use_reentrant=False)
        else:
            x, nc = _dec_block(bp, cfg, x, positions, cross[i],
                               None if self_caches is None else self_caches[i],
                               cache_index, tp, caches is not None)
        new_self.append(nc)

    if last_only:
        x = x[:, -1:]
    x = _ln(params.dec_norm, cfg, x)
    w_out = params.embed.T.to(dt)                       # tied
    logits = x @ w_out if tp is None else tp.unembed(x, w_out, True)
    if csplit is not None and embeddings is not None:
        # the prefill's whole cross K/V → the head_dim slices cached
        cross = [{k: csplit.store(v) for k, v in c.items()} for c in cross]
    new_caches = None if caches is None else {"self": new_self,
                                              "cross": cross}
    return logits, new_caches, torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def init_cache(cfg, batch: int, seq_len: int, *, device="cuda"):
    """``{"self": per-layer linear KV caches of length seq_len, "cross":
    per-layer zero cross K/V (B, encoder_seq_len, K, hd)}``."""
    shape = (batch, cfg.encdec.encoder_seq_len, cfg.num_kv_heads,
             cfg.head_dim_)
    dt = L.dtype_of(cfg.dtype)
    return {"self": [L.init_kv_cache(cfg, batch, seq_len, device=device)
                     for _ in range(cfg.num_layers)],
            "cross": [{"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}
                      for _ in range(cfg.num_layers)]}


def _read_in_f32(name: str) -> bool:
    """The forward reads the LayerNorms (``ln1``–``ln3``, ``enc_norm``,
    ``dec_norm``) in f32; every other parameter only through a cast to
    ``cfg.dtype``."""
    owner = name.split(".")[-2:-1]
    return bool(owner) and (owner[0].startswith("ln")
                            or owner[0].endswith("norm"))


def cast_for_serving(model: EncDec, cfg) -> EncDec:
    """Cast, once, every parameter the forward reads only through a cast
    to ``cfg.dtype``, replacing each tensor in place (peak memory stays the
    f32 model plus its largest tensor). The numbers are unchanged."""
    dt = L.dtype_of(cfg.dtype)
    for name, p in model.named_parameters():
        if not _read_in_f32(name):
            p.data = p.data.to(dt)
    return model
