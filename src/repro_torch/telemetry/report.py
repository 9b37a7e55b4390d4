"""Harness counters: the kernel and program side of ``telemetry.report()``.

Everything here reads state the port already tracks: the kernel wrappers'
``launches`` counters in :mod:`repro_torch.kernels.ops` (raised where a
kernel launches on the card, and by every replay of a captured round
program by the launches its capture recorded), and the program cache of
:mod:`repro_torch.core.scanloop` — its hits, misses, inserts and
evictions, the bytes its programs hold, and the variants built and graphs
captured per driver family (:func:`~repro_torch.core.scanloop.cache_stats`)
— so "did my sweep recapture anything?" is one call away.
"""
from __future__ import annotations

from repro_torch.core import scanloop
from repro_torch.kernels import ops

#: the port's kernel wrappers, in the kernel table's order (B1–B4, B3′, B4′)
KERNELS = scanloop.COUNTED_KERNELS


def harness_report() -> dict:
    """``kernel_launches``: {wrapper name: launches so far};
    ``program_cache``: :func:`scanloop.cache_stats`."""
    return {"kernel_launches": {n: getattr(ops, n).launches
                                for n in KERNELS},
            "program_cache": scanloop.cache_stats()}
