"""Plain PyTorch versions of the hand-written kernels, in the kernels'
layout: the port's counterpart of the JAX package's ``kernels/ref.py``
oracles.

The consensus and recurrence versions take the same rounded steps as
their CUDA kernels in the same order, so on the card each kernel matches
its plain version bit for bit. The attention version,
:func:`attention_reference` (O(S·T) memory), is also the model's decode
attention over the KV cache; the online-softmax kernel matches it within
rounding. Apart from decode attention, only the CPU path of
:mod:`repro_torch.kernels.ops`, the tests and ``chip_smoke.py``'s
comparison call them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def consensus_update_pop_reference(x, idx, sig, src=None):
    """x + Σ_h σ_h (src[idx_h] − x) per agent: x (K, N) f32/bf16, src
    (Ks, N) of x's dtype (None: x itself), idx (K, H) int in [0, Ks), sig
    (K, H) f32 → (K, N) in x's dtype, f32 accumulation."""
    xf = x.to(torch.float32)
    sf = xf if src is None else src.to(torch.float32)
    acc = torch.zeros_like(xf)
    idx = idx.long()
    for h in range(idx.shape[1]):
        acc = acc + sig[:, h:h + 1].to(torch.float32) * (sf[idx[:, h]] - xf)
    return (xf + acc).to(x.dtype)


def dequantize_rows(q, s, qblock: Optional[int] = None):
    """Decoded f32 rows of an int wire: q (K, N) int8; s (K,) per-tensor
    scales, or (K, ⌈N/qblock⌉) block scales."""
    qf = q.to(torch.float32)
    if qblock is None:
        return qf * s.to(torch.float32)[:, None]
    full = s.to(torch.float32).repeat_interleave(qblock, dim=1)
    return qf * full[:, :q.shape[1]]


def quant_consensus_pop_reference(x, q, s, idx, sig,
                                  qblock: Optional[int] = None,
                                  q_src=None, s_src=None):
    """x + Σ_h σ_h (ŝ_h q_h − ŝ_k q_k) per agent, recentred on the agent's
    own decoded copy: x (K, N) f32, q (K, N) int8, scales as in
    :func:`dequantize_rows`; neighbours from the wire ``q_src`` (Ks, N),
    ``s_src`` (None: q, s) → (K, N) f32."""
    xhat = dequantize_rows(q, s, qblock)
    nbr = xhat if q_src is None else dequantize_rows(q_src, s_src, qblock)
    acc = torch.zeros_like(xhat)
    idx = idx.long()
    for h in range(idx.shape[1]):
        acc = acc + sig[:, h:h + 1].to(torch.float32) * (nbr[idx[:, h]] - xhat)
    return x.to(torch.float32) + acc


def rglru_scan_reference(log_a, b, h0=None):
    """h_t = exp(log_a_t)·h_{t-1} + b_t stepped in time order, carry in f32:
    log_a, b (B, T, W) f32/bf16, h0 (B, W) or None → (h (B, T, W) in
    log_a's dtype, h_last (B, W) f32). f64 inputs carry in f64 (the
    tests' gradient checks)."""
    B, T, W = log_a.shape
    acc = torch.promote_types(log_a.dtype, torch.float32)
    if log_a.device.type == "meta" and T > 1:
        return _rglru_scan_meta(log_a, b, h0, acc)
    h = (torch.zeros(B, W, dtype=acc, device=log_a.device)
         if h0 is None else h0.to(acc))
    out = []
    for t in range(T):
        h = torch.exp(log_a[:, t].to(acc)) * h + b[:, t].to(acc)
        out.append(h.to(log_a.dtype))
    return torch.stack(out, dim=1), h


def _rglru_scan_meta(log_a, b, h0, acc):
    """The time loop on ``meta`` tensors (the dry run,
    :mod:`repro_torch.launch.dryrun`), where only shapes exist: every step
    at once, reading b's previous step (h0 first) in place of h_{t-1}
    (the same shape; values do not exist on meta), so the elementwise
    bytes, the saved activations and the gradient's operands are the
    loop's, in T times fewer dispatches."""
    bt = b.to(acc)
    prev = bt[:, :-1]
    if h0 is not None:
        prev = torch.cat([h0.to(acc)[:, None], prev], dim=1)
    else:
        prev = torch.cat([torch.zeros_like(bt[:, :1]), prev], dim=1)
    h = torch.exp(log_a.to(acc)) * prev + bt
    return h.to(log_a.dtype), h[:, -1]


NEG_INF = -2.0 ** 30


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(q, k) additive f32 bias from causal + sliding-window constraints."""
    ok = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, softcap: float = 0.0,
                        k_len: Optional[torch.Tensor] = None):
    """Plain O(S·T)-memory attention. (B,S,H,hd)x(B,T,K,hd) -> (B,S,H,hd).

    GQA: H % K == 0; q head h attends kv head h // (H//K).
    ``k_len``: optional (B,) number of valid kv positions (decode caches).
    q is scaled in f32 and cast back to its dtype; products of the storage
    dtypes accumulate in f32 (exact upcasts, as JAX's
    ``preferred_element_type``); probabilities are cast to v's dtype.
    f64 inputs compute in f64 (the tests' gradient checks).
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = (q.to(acc) / math.sqrt(hd)).to(q.dtype)
    qf = qf.reshape(B, S, K, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qf.to(acc), k.to(acc))
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    q_pos = q_offset + torch.arange(S, device=q.device)
    k_pos = torch.arange(T, device=q.device)
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)
    if k_len is not None:
        valid = k_pos[None, :] < k_len[:, None]                  # (B, T)
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).to(acc),
                       v.to(acc))
    return out.reshape(B, S, H, hd).to(q.dtype)
