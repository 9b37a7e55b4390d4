"""Plain PyTorch versions of the two consensus kernels, at the population
level and in the kernels' layout: the port's counterpart of the JAX
package's ``kernels/ref.py`` oracles.

Each sums the same terms as the CUDA kernel in the same fixed h order,
one rounded operation at a time, so on the card the kernel matches it
bit for bit. Only the CPU path of :mod:`repro_torch.kernels.ops`, the
tests and ``chip_smoke.py``'s comparison call them.
"""
from __future__ import annotations

from typing import Optional

import torch


def consensus_update_pop_reference(x, idx, sig):
    """x + Σ_h σ_h (x[idx_h] − x) per agent: x (K, N) f32/bf16, idx (K, H)
    int, sig (K, H) f32 → (K, N) in x's dtype, f32 accumulation."""
    xf = x.to(torch.float32)
    acc = torch.zeros_like(xf)
    idx = idx.long()
    for h in range(idx.shape[1]):
        acc = acc + sig[:, h:h + 1].to(torch.float32) * (xf[idx[:, h]] - xf)
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
                                  qblock: Optional[int] = None):
    """x + Σ_h σ_h (ŝ_h q_h − ŝ_k q_k) per agent, recentred on the agent's
    own decoded copy: x (K, N) f32, q (K, N) int8, scales as in
    :func:`dequantize_rows` → (K, N) f32."""
    xhat = dequantize_rows(q, s, qblock)
    acc = torch.zeros_like(xhat)
    idx = idx.long()
    for h in range(idx.shape[1]):
        acc = acc + sig[:, h:h + 1].to(torch.float32) * (xhat[idx[:, h]] - xhat)
    return x.to(torch.float32) + acc
