"""Shared building blocks of the port's models.

Conventions follow the JAX package's ``models/layers.py``: activations run
in ``cfg.dtype``, parameters are stored in ``cfg.param_dtype`` and cast at
each use, norms and softmax run in f32, and weights keep the JAX layouts
(``wq (d, H, hd)``, ``wo (H, hd, d)``, MLP ``(in, out)``). Parameters live
in ``nn.Module``s and are trainable; the serving steps run under
``torch.no_grad()``. The training path reads the same blocks from a flat
``{name: tensor}`` dict in the JAX package's leaf structure
(:func:`repro_torch.models.transformer.stack_params`).

Attention over a fresh sequence from position 0 (prefill, or a forward
without cache) goes to the hand-written flash-attention kernel through
:func:`repro_torch.kernels.ops.flash_attention` (the JAX package's
``attention`` dispatch picks its XLA paths there). Decode attends over the KV
cache with the kernel's plain version,
:func:`repro_torch.kernels.ref.attention_reference`, and ``k_len``, as the
JAX package does. The JAX attention block's GSPMD sharding constraints wait
for the multi-GPU slice.
"""
from __future__ import annotations

import math
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


def _heads_in(x, w):
    """einsum('bsd,dhk->bshk')."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attention_block(p, cfg, x, positions, *, window: int = 0, cache=None,
                    cache_index: Optional[int] = None):
    """Self-attention with optional KV cache. Returns (out, new_cache).

    cache: dict(k=(B, C, K, hd), v=(B, C, K, hd)); C == window for SWA
    (circular buffer, slot = position % C), else C == max seq (linear).
    cache_index: number of tokens already in the cache. Prefill (S > 1)
    assumes cache_index == 0 (single-shot prefill); decode (S == 1)
    supports any index. The cache is updated out of place.
    """
    dt = dtype_of(cfg.dtype)
    x = x.to(dt)
    B, S, _ = x.shape
    q = _heads_in(x, p.wq.to(dt))
    k = _heads_in(x, p.wk.to(dt))
    v = _heads_in(x, p.wv.to(dt))
    if cfg.use_qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, p.rope_inv)
        k = apply_rope(k, positions, p.rope_inv)

    def project_out(out):
        wo = p.wo.to(dt)
        return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])

    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.logit_softcap)
        return project_out(out), None

    C = cache["k"].shape[1]
    idx = 0 if cache_index is None else int(cache_index)
    cdt = cache["k"].dtype

    if window > 0 and C == window:
        # circular: write the last min(S, C) tokens at slot = position % C
        tail = min(S, C)
        slots = (idx + (S - tail) + torch.arange(tail, device=x.device)) % C
        ck = cache["k"].index_copy(1, slots, k[:, S - tail:].to(cdt))
        cv = cache["v"].index_copy(1, slots, v[:, S - tail:].to(cdt))
        if S > 1:
            # single-shot prefill: attention over the fresh sequence
            out = ops.flash_attention(q, k, v, causal=True, window=window,
                                      softcap=cfg.logit_softcap)
        else:
            # decode: every valid cache slot is an in-window past position
            kl = torch.full((B,), min(idx + S, C), dtype=torch.int32,
                            device=x.device)
            out = attention_reference(q, ck, cv, causal=False, window=0,
                                      softcap=cfg.logit_softcap, k_len=kl)
        return project_out(out), {"k": ck, "v": cv}

    # linear buffer (the start clamps so the update fits, as
    # dynamic_update_slice does)
    start = min(max(idx, 0), C - S)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    ck[:, start:start + S] = k.to(cdt)
    cv[:, start:start + S] = v.to(cdt)
    if S > 1:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.logit_softcap)
    else:
        kl = torch.full((B,), idx + S, dtype=torch.int32, device=x.device)
        out = attention_reference(q, ck, cv, causal=True, window=window,
                                  q_offset=idx, softcap=cfg.logit_softcap,
                                  k_len=kl)
    return project_out(out), {"k": ck, "v": cv}


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


def mlp_block(p, cfg, x):
    dt = dtype_of(cfg.dtype)
    x = x.to(dt)
    act = act_fn(cfg.act)
    if hasattr(p, "w_gate"):
        h = act(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
        return h @ p.w_down.to(dt)
    h = act(x @ p.w_up.to(dt) + p.b_up.to(dt))
    return h @ p.w_down.to(dt) + p.b_down.to(dt)
