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


def rglru_scan_backward_reference(log_a, b, h0, h, g_h, g_last=None):
    """The scan's vector-Jacobian product, stepped backwards in time in
    f32 with a_t = exp(log_a_t) and h_{t-1} the f32 carry (h0 first):

        λ_{T-1} = g_{T-1} + g_last,   λ_t = g_t + a_{t+1}·λ_{t+1}
        db_t = λ_t,   d log_a_t = (λ_t·h_{t-1})·a_t,   dh0 = λ_0·a_0

    log_a, b (B, T, W), h0 (B, W) or None (zeros), h the forward's output
    or None (the carry itself for f32 inputs; for bf16, or without h, the
    carry is recomputed by a forward walk), g_h (B, T, W) the cotangent of
    h, g_last (B, W) f32 or None → (d log_a, db in their inputs' dtypes,
    dh0 (B, W) in the carry's dtype: f32, f64 for f64 inputs). The rounded
    steps are those of autograd through :func:`rglru_scan_reference`, in
    the same order, so the two are equal bit for bit."""
    B, T, W = log_a.shape
    acc = torch.promote_types(log_a.dtype, torch.float32)
    h0 = (torch.zeros(B, W, dtype=acc, device=log_a.device)
          if h0 is None else h0.to(acc))
    if h is not None and h.dtype == acc:
        carry = h
    else:
        carry, c = [], h0
        for t in range(T):
            c = torch.exp(log_a[:, t].to(acc)) * c + b[:, t].to(acc)
            carry.append(c)
        carry = torch.stack(carry, dim=1)
    dla, db = [None] * T, [None] * T
    lam = a_next = None
    for t in range(T - 1, -1, -1):
        a = torch.exp(log_a[:, t].to(acc))
        g = g_h[:, t].to(acc)
        if lam is None:
            lam = g if g_last is None else g + g_last.to(acc)
        else:
            lam = g + lam * a_next
        prev = h0 if t == 0 else carry[:, t - 1]
        db[t] = lam.to(b.dtype)
        dla[t] = ((lam * prev) * a).to(log_a.dtype)
        a_next = a
    return torch.stack(dla, dim=1), torch.stack(db, dim=1), lam * a_next


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


def attention_backward_reference(q, k, v, g, *, causal: bool = True,
                                 window: int = 0, softcap: float = 0.0):
    """The FlashAttention-2 gradient of :func:`attention_reference` (no
    ``q_offset`` / ``k_len``): q (B, S, H, hd), k, v (B, T, K, hd) and the
    cotangent ``g`` (B, S, H, hd) of the output → (dq, dk, dv) in their
    inputs' dtypes. With q_scaled = q / sqrt(hd) rounded to q's dtype as
    the forward rounds it, and in f32:

        P = exp(s − logsumexp(s)) of the (soft-capped, masked) scores s
        dP = g vᵀ,   D = Σ_t P dP,   dV = Pᵀ g,   dS = P ∘ (dP − D)
        dS ∘= 1 − tanh²(s_raw / softcap)     (softcap > 0)
        dK = dSᵀ q_scaled,   dQ = dS k / sqrt(hd)

    summed over the H/K query heads of each kv head. D is rowsum(g ∘ out)
    of the unrounded output: a bf16 output's rounding would fall on the
    difference dP − D. Autograd through the plain forward reaches the same
    values by another route (in bf16 with roundings of dP and dq between
    its casts); the tests hold the two within their stated tolerances."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    grp = H // K
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q.to(acc) / math.sqrt(hd)).to(q.dtype).to(acc)
    qs = qs.reshape(B, S, K, grp, hd)
    kf, vf = k.to(acc), v.to(acc)
    raw = torch.einsum("bskgh,btkh->bkgst", qs, kf)
    if softcap > 0:
        th = torch.tanh(raw / softcap)
        raw = softcap * th
    s = raw + _mask_bias(torch.arange(S, device=q.device),
                         torch.arange(T, device=q.device), causal, window)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    gf = g.to(acc).reshape(B, S, K, grp, hd)
    dv = torch.einsum("bkgst,bskgh->btkh", p, gf)
    dp = torch.einsum("bskgh,btkh->bkgst", gf, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if softcap > 0:
        ds = ds * (1 - th * th)
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qs)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) / math.sqrt(hd)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
