"""Shared building blocks of the port's models.

Conventions follow the JAX package's ``models/layers.py``: activations run
in ``cfg.dtype``, parameters are stored in ``cfg.param_dtype`` and cast at
each use, norms and softmax run in f32, and weights keep the JAX layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, MLP ``(in, out)``). Parameters live
in ``nn.Module``s and are trainable; the serving steps run under
``torch.no_grad()``. The training path reads the same blocks from a flat
``{name: tensor}`` dict in the JAX package's leaf structure (each model's
``stack_params``; :func:`stack_layers` and :func:`unstack_layers` move a
group of layers between the two).

Attention over a fresh sequence from position 0 (prefill, or a forward
without cache) or over an encoder's states (the encoder-decoder's
unmasked self- and cross-attention, S > 1) goes to the hand-written
flash-attention kernel through :func:`repro_torch.kernels.ops.
flash_attention` (the JAX package's ``attention`` dispatch and its
``attention_reference`` pick XLA paths there). Decode (S == 1) attends
over the KV cache, or the encoder's cross K/V, with the kernel's plain
version, :func:`repro_torch.kernels.ref.attention_reference` (``k_len``
for a cache), as the JAX package does. On a data x model mesh the block
reads this rank's heads (:mod:`repro_torch.sharding.parallel`), so the
kernel gets them as plain tensors; the JAX block's GSPMD layout
constraints (q over heads at prefill, q on the cache's layout at decode)
have no counterpart: the explicit shards already sit where the kernel
reads them.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_reference


def dense_init(shape, *, generator: Optional[torch.Generator] = None,
               dtype=torch.float32, device="cuda",
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±3, times
    ``scale`` or 1/√fan_in (fan-in is the first dimension)."""
    fan_in = max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return w.mul_(std).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A trainable parameter."""
    return nn.Parameter(t)


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def layer_row(name: str, groups) -> tuple:
    """A module param's JAX name and layer row: ``{group}.<i>.<leaf>`` of
    a group in ``groups`` → (``{group}.<leaf>``, i), row i of a leaf
    stacked over the group's layers; any other name → (name, None), a
    leaf as it is."""
    group, _, rest = name.partition(".")
    if group not in groups:
        return name, None
    i, _, leaf = rest.partition(".")
    return f"{group}.{leaf}", int(i)


def stack_layers(named: dict, jax_name) -> dict:
    """A module's named params → its JAX leaf structure. ``jax_name(name)``
    gives each param's JAX name and its row on that leaf's leading layer
    axis, or None for a leaf as it is (:func:`layer_row`); the rows of a
    leaf are stacked in row order, placed where its first row stood. All
    detached."""
    rows: dict = {}
    for name, t in named.items():
        key, row = jax_name(name)
        rows.setdefault(key, {})[row] = t.detach()
    return {key: r[None] if None in r else torch.stack(
        [r[i] for i in range(len(r))]) for key, r in rows.items()}


def namespace(flat: dict) -> SimpleNamespace:
    """``{"attn.wq": t}`` → a namespace tree read as ``ns.attn.wq``."""
    groups: dict = {}
    for name, t in flat.items():
        head, _, rest = name.partition(".")
        if rest:
            groups.setdefault(head, {})[rest] = t
        else:
            groups[head] = t
    return SimpleNamespace(**{k: namespace(v) if isinstance(v, dict) else v
                              for k, v in groups.items()})


def unstack_layers(params: dict, group: str, n: int, cfg=None) -> list:
    """The inverse view of :func:`stack_layers`: ``{group}.<leaf>`` (n,
    ...) → a list of n per-layer namespaces of views, each
    :func:`with_rope`. The views come from one ``unbind`` a leaf, whose
    backward stacks the n layer gradients once; indexing each layer
    would give every layer's gradient the whole stack's shape and add
    them up, n full-size passes a leaf."""
    prefix = f"{group}."
    rows = {k[len(prefix):]: v.unbind(0) for k, v in params.items()
            if k.startswith(prefix)}
    return [with_rope(namespace({k: v[i] for k, v in rows.items()}), cfg)
            for i in range(n)]


def with_rope(bp: SimpleNamespace, cfg=None) -> SimpleNamespace:
    """Give a layer namespace's ``attn`` its ``rope_inv`` (the module's
    buffer) when ``cfg`` uses RoPE; ``bp`` itself."""
    if cfg is not None and cfg.rope_theta > 0 and hasattr(bp, "attn"):
        bp.attn.rope_inv = rope_inv(cfg.head_dim_, cfg.rope_theta,
                                    bp.attn.wq.device)
    return bp


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm with the ``1 + weight`` scale, computed in f32."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis, statistics in f32, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


_ROPE_INV: dict = {}


def rope_inv(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once per (head_dim,
    theta, device): a host-to-device copy at each use would synchronise
    the stream twice a layer."""
    key = (head_dim, theta, str(torch.device(device)))
    if key not in _ROPE_INV:
        _ROPE_INV[key] = torch.from_numpy(rope_freqs(head_dim, theta)).to(
            device)
    return _ROPE_INV[key]


def apply_rope(x, positions, inv_freq):
    """Half-split rotary embedding. x (..., seq, heads, head_dim);
    positions (..., seq); ``inv_freq`` (head_dim/2,) f32 on x's device,
    ``rope_freqs(head_dim, theta)``."""
    ang = positions[..., :, None].to(torch.float32) * inv_freq   # (..., S, hd/2)
    ang = ang[..., None, :]                                      # (..., S, 1, hd/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """q/k/v/o projections in the JAX layouts, and the q/k RMS norms over
    head_dim when ``use_qk_norm``: the JAX package's ``init_attention``.
    RoPE's inverse frequencies are a buffer outside the state dict."""

    def __init__(self, cfg, *, generator=None, device="cuda"):
        super().__init__()
        d = cfg.d_model
        hd = cfg.head_dim_
        pd = dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, dtype=pd, device=device)
        self.wq = param(dense_init((d, cfg.num_heads, hd), **kw))
        self.wk = param(dense_init((d, cfg.num_kv_heads, hd), **kw))
        self.wv = param(dense_init((d, cfg.num_kv_heads, hd), **kw))
        self.wo = param(dense_init((cfg.num_heads, hd, d), **kw,
                                   scale=1.0 / math.sqrt(cfg.num_heads * hd)))
        if cfg.use_qk_norm:
            self.q_norm = param(torch.zeros(hd, dtype=pd, device=device))
            self.k_norm = param(torch.zeros(hd, dtype=pd, device=device))
        if cfg.rope_theta > 0:
            self.register_buffer("rope_inv", rope_inv(hd, cfg.rope_theta,
                                                      device),
                                 persistent=False)


def decode_positions(S: int, cache_index, device):
    """(S,) int64 positions from ``cache_index`` (None: 0; a Python int,
    or a 0-d integer tensor on the device, added there: no host sync)."""
    return torch.arange(S, device=device) + (
        0 if cache_index is None else cache_index)


def heads_in(x, w):
    """einsum('bsd,dhk->bshk')."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attention_block(p, cfg, x, positions, *, window: int = 0, cache=None,
                    cache_index: Optional[int] = None, cross_kv=None,
                    split=None):
    """Self- (or cross-) attention with optional KV cache. Returns (out,
    new_cache).

    cache: dict(k=(B, C, K, hd), v=(B, C, K, hd)); C == window for SWA
    (circular buffer, slot = position % C), else C == max seq (linear).
    cache_index: number of tokens already in the cache, a Python int or
    a 0-d integer tensor on the device (as the JAX package traces it: a
    captured decode step reads its position from the device, and the
    clamped start, the circular slots, the valid length and the query
    offset are then computed there; the same bits either way). Prefill
    (S > 1) assumes cache_index == 0 (single-shot prefill); decode (S ==
    1) supports any index. The cache is updated out of place.
    cross_kv: (k, v) (B, T, K, hd) given (an encoder's states): q comes
    from x, k and v get no norm and no RoPE, nothing is masked, and the
    cache comes back untouched.
    split: a :class:`repro_torch.sharding.parallel.CacheSplit` when the
    cache (or, at decode, the cross K/V) holds this rank's head_dim slice
    of every kv head: ``p``'s kv projection is whole, the kernel runs on
    this rank's query heads at a prefill, the cache stores the slice, and
    a decode step reads it through the split's collectives.
    """
    dt = dtype_of(cfg.dtype)
    x = x.to(dt)
    B, S, _ = x.shape
    q = heads_in(x, p.wq.to(dt))
    if cross_kv is not None:
        k, v = cross_kv
    else:
        k = heads_in(x, p.wk.to(dt))
        v = heads_in(x, p.wv.to(dt))
    if cfg.use_qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, p.rope_inv)
        if cross_kv is None:
            k = apply_rope(k, positions, p.rope_inv)

    def project_out(out):
        wo = p.wo.to(dt)
        return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])

    if cross_kv is not None:
        kw = dict(causal=False, window=0, softcap=cfg.logit_softcap)
        if split is None:
            out = (ops.flash_attention(q, k, v, **kw) if S > 1
                   else attention_reference(q, k, v, **kw))
        elif S > 1:                 # the encoder's whole K/V, just computed
            out = ops.flash_attention(q, split.for_kernel(k),
                                      split.for_kernel(v), **kw)
        else:                       # the cached head_dim slices
            out = split.decode(q, k, v, q_offset=0, k_len=None, **kw)
        return project_out(out), cache

    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.logit_softcap)
        return project_out(out), None

    C = cache["k"].shape[1]
    idx = 0 if cache_index is None else cache_index
    cdt = cache["k"].dtype
    # what the cache stores, and the kv heads the kernel reads at a prefill
    k_st, v_st = (k, v) if split is None else (split.store(k), split.store(v))
    k_in, v_in = (k, v) if split is None else (split.for_kernel(k),
                                               split.for_kernel(v))

    if window > 0 and C == window:
        # circular: write the last min(S, C) tokens at slot = position % C
        tail = min(S, C)
        slots = (idx + (S - tail) + torch.arange(tail, device=x.device)) % C
        ck = cache["k"].index_copy(1, slots, k_st[:, S - tail:].to(cdt))
        cv = cache["v"].index_copy(1, slots, v_st[:, S - tail:].to(cdt))
        if S > 1:
            # single-shot prefill: attention over the fresh sequence
            out = ops.flash_attention(q, k_in, v_in, causal=True,
                                      window=window,
                                      softcap=cfg.logit_softcap)
        else:
            # decode: every valid cache slot is an in-window past position
            kl = _k_len(idx + S, B, x.device, at_most=C)
            kw = dict(causal=False, window=0, softcap=cfg.logit_softcap,
                      k_len=kl)
            out = (attention_reference(q, ck, cv, **kw) if split is None
                   else split.decode(q, ck, cv, q_offset=0, **kw))
        return project_out(out), {"k": ck, "v": cv}

    # linear buffer (the start clamps so the update fits, as
    # dynamic_update_slice does)
    start = (idx.clamp(0, C - S) if isinstance(idx, torch.Tensor)
             else min(max(idx, 0), C - S))
    rows = start + torch.arange(S, device=x.device)
    ck = cache["k"].index_copy(1, rows, k_st.to(cdt))
    cv = cache["v"].index_copy(1, rows, v_st.to(cdt))
    if S > 1:
        out = ops.flash_attention(q, k_in, v_in, causal=True, window=window,
                                  softcap=cfg.logit_softcap)
    else:
        kl = _k_len(idx + S, B, x.device)
        kw = dict(causal=True, window=window, q_offset=idx,
                  softcap=cfg.logit_softcap, k_len=kl)
        out = (attention_reference(q, ck, cv, **kw) if split is None
               else split.decode(q, ck, cv, **kw))
    return project_out(out), {"k": ck, "v": cv}


def _k_len(n, B: int, device, *, at_most: Optional[int] = None):
    """The (B,) int32 valid cache length ``n`` (at most ``at_most``): a
    fill for a Python int, device ops for a 0-d tensor."""
    if isinstance(n, torch.Tensor):
        if at_most is not None:
            n = torch.clamp(n, max=at_most)
        return n.to(torch.int32).expand(B)
    if at_most is not None:
        n = min(n, at_most)
    return torch.full((B,), n, dtype=torch.int32, device=device)


def init_kv_cache(cfg, batch: int, seq_len: int, *, window: int = 0,
                  dtype=None, device="cuda"):
    """Allocate a KV cache: full length, or the SWA window if smaller."""
    C = min(seq_len, window) if window > 0 else seq_len
    shape = (batch, C, cfg.num_kv_heads, cfg.head_dim_)
    dt = dtype_of(dtype or cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class Mlp(nn.Module):
    """The JAX package's ``init_mlp``: gated (``w_gate``, ``w_up``,
    ``w_down``) or plain (``w_up``, ``b_up``, ``w_down``, ``b_down``) by
    ``cfg.mlp_kind``; ``d_ff`` overrides ``cfg.d_ff`` (the MoE's shared
    expert)."""

    def __init__(self, cfg, *, d_ff: Optional[int] = None, generator=None,
                 device="cuda"):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        pd = dtype_of(cfg.param_dtype)
        kw = dict(generator=generator, dtype=pd, device=device)
        if cfg.mlp_kind == "gated":
            self.w_gate = param(dense_init((d, f), **kw))
            self.w_up = param(dense_init((d, f), **kw))
            self.w_down = param(dense_init((f, d), **kw))
        else:
            self.w_up = param(dense_init((d, f), **kw))
            self.b_up = param(torch.zeros(f, dtype=pd, device=device))
            self.w_down = param(dense_init((f, d), **kw))
            self.b_down = param(torch.zeros(d, dtype=pd, device=device))


def act_fn(name: str):
    """The MLP activations by config name; GELU is the tanh approximation,
    ``jax.nn.gelu``'s default."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_block(p, cfg, x, region=None):
    """The gated or plain MLP. ``region``: its
    :class:`repro_torch.sharding.parallel.Region` on a mesh (``p`` this
    rank's columns of ``w_gate``/``w_up`` and rows of ``w_down``, a plain
    MLP's ``b_up`` cut to those columns): ``x`` enters through *f*, the
    partial sums leave through *g*, and ``b_down`` is added once after
    it."""
    dt = dtype_of(cfg.dtype)
    x = x.to(dt)
    act = act_fn(cfg.act)
    enter = (lambda t: t) if region is None else region.enter
    reduce = (lambda t: t) if region is None else region.reduce
    x = enter(x)
    if hasattr(p, "w_gate"):
        h = act(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
        return reduce(h @ p.w_down.to(dt))
    h = act(x @ p.w_up.to(dt) + p.b_up.to(dt))
    return reduce(h @ p.w_down.to(dt)) + p.b_down.to(dt)
