"""The work of one call of each hand-written kernel: the bytes it must move
(each input read once, each output written once) and the operations it
does, as functions of the call's shapes and flags.

Two readers share these formulas: ``chip_smoke.py``'s bound column (least
time = the larger of bytes over the memory rate and operations over the
peak rate) and the dry run (:mod:`repro_torch.launch.hlo_analysis`),
which adds each kernel call's count to the FLOPs and bytes it records.
The kernels launch through ``ctypes``, below the dispatcher, where
``torch.utils.flop_counter.FlopCounterMode`` cannot see them; on ``meta``
tensors (the dry run) each wrapper launches nothing and reports its count
here instead (:func:`add`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

#: callables ``sink(name, flops, nbytes)`` that :func:`add` reports to
_SINKS: List[Callable] = []


@contextlib.contextmanager
def counting(sink: Callable):
    """Within the block, every kernel call on ``meta`` tensors reports
    ``sink(name, flops, nbytes)``."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def add(name: str, work: Tuple[int, int]):
    """Report one kernel call's ``(nbytes, flops)`` to every sink."""
    nbytes, flops = work
    for sink in list(_SINKS):
        sink(name, flops, nbytes)


def consensus_update_pop(K: int, N: int, H: int, elem: int = 4):
    """B2: (bytes, flops) of K owned rows of N elements over H lanes. x
    read and out written (``elem`` bytes each per element), the int32
    index and f32 weight lane tables; sub, mul and add per lane per
    element, then x + acc."""
    return 2 * elem * K * N + 8 * K * H, 3 * K * N * H + K * N


def quant_consensus_pop(K: int, N: int, H: int, scales: int):
    """B1: (bytes, flops) of K owned f32 rows of N elements over H lanes
    with ``scales`` f32 scales. x read and out written (4 + 4 per
    element), the int8 lanes (1), the scales and the lane tables;
    dequantize, sub, mul and add per lane per element, the own dequantize,
    then x + acc."""
    return (9 * K * N + 4 * scales + 8 * K * H,
            4 * K * N * H + 2 * K * N)


def rglru_scan(B: int, T: int, W: int, *, with_h0: bool, elem: int = 4):
    """B3: (bytes, flops) of the scan over (B, T, W). log_a and b read and
    h written (``elem`` bytes each per element), h0 read (f32, when given)
    and h_last written (f32); exp, mul and add per element."""
    n = B * T * W
    return 3 * elem * n + (8 if with_h0 else 4) * B * W, 3 * n


def rglru_scan_backward(B: int, T: int, W: int, *, with_h0: bool,
                        with_g_last: bool, elem: int = 4):
    """B3′: (bytes, flops) of the scan's VJP over (B, T, W). log_a, the
    carry's source (the saved h for f32, b for bf16) and g read, d log_a
    and db written (``elem`` bytes each per element); h0 and g_last read
    (f32, when given) and dh0 written (f32); per element an exp, the
    adjoint's multiply and add and d log_a's two multiplies."""
    n = B * T * W
    rows = 4 * (1 + int(with_h0) + int(with_g_last)) * B * W
    return 5 * elem * n + rows, 5 * n


def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave visible, positions from 0:
    query i sees keys [lo_i, hi_i], hi_i = min(i, T − 1) under ``causal``
    (else T − 1), lo_i = max(i − window + 1, 0) with a ``window``."""
    total = 0
    for i in range(S):
        hi = min(i, T - 1) if causal else T - 1
        lo = max(i - window + 1, 0) if window > 0 else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_attention(B: int, S: int, T: int, H: int, K: int, hd: int, *,
                    causal: bool, window: int, elem: int):
    """B4: (bytes, flops) of q (B, S, H, hd) over k, v (B, T, K, hd). q
    read and out written, k and v read (``elem`` bytes per element); 4·hd
    flops (q·k and p·v, a multiply and an add each) per visible (query,
    key) pair per (batch, query head): the pairs the masks leave, which
    is what the kernel computes, not the full S·T."""
    nbytes = elem * (2 * B * S * H * hd + 2 * B * T * K * hd)
    return nbytes, 4 * hd * visible_pairs(S, T, causal, window) * B * H


def flash_attention_backward(B: int, S: int, T: int, H: int, K: int,
                             hd: int, *, causal: bool, window: int,
                             elem: int):
    """B4′: (bytes, flops) of the attention's VJP. q, g read and dq
    written, k, v read and dk, dv written (``elem`` bytes per element),
    and each query row's log-sum-exp and D (f32) written once; 10·hd flops
    per visible (query, key) pair per (batch, query head): the scores
    q·k, dP = g·v, and dV += P g, dK += dS q, dQ += dS k, a multiply and
    an add each."""
    nbytes = (elem * (3 * B * S * H * hd + 4 * B * T * K * hd)
              + 2 * 4 * B * H * S)
    return nbytes, 10 * hd * visible_pairs(S, T, causal, window) * B * H
