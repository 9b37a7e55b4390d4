"""Harness counters: the kernel side of ``telemetry.report()``.

The JAX package reports its compiled-program cache here (trace counts,
cache hits and evictions, donation flags). Eager PyTorch traces, compiles
and caches no round program, so the port has no program-cache section;
what it can count instead is how often each hand-written kernel launched
(the wrappers' ``launches`` counters in :mod:`repro_torch.kernels.ops`,
raised only where a kernel is launched on the card).
"""
from __future__ import annotations

from repro_torch.kernels import ops

#: the port's kernel wrappers, in the kernel table's order (B1–B4)
KERNELS = ("quant_consensus_pop", "consensus_update_pop", "rglru_scan",
           "flash_attention")


def harness_report() -> dict:
    """``{"kernel_launches": {wrapper name: launches so far}}``."""
    return {"kernel_launches": {n: getattr(ops, n).launches
                                for n in KERNELS}}
