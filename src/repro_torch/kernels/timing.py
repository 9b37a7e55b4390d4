"""The device time of one call of a kernel's wrapper, alone: CUDA events
around calls queued back to back while the card is held busy, so that
none of the wrapper's host work is on the clock.

A ``torch.profiler`` trace is not used for this: on an H100 it was seen to
record every launch but drop the first kernel events of a trace, more
the longer the process had run (``tools/trace_drops.py``).

Imports only ``torch`` and the standard library, so that
``tools/kernel_times.py`` can load this file by its path while it imports
the package of another checkout.
"""
from __future__ import annotations

#: how long the card is first held while the host queues the calls, in
#: clock cycles of ``torch.cuda._sleep`` (about 25 ms at 2 GHz), and how
#: many times that is quadrupled before :func:`device_ms` gives up
HOLD_CYCLES = 50_000_000
HOLDS = 3


def _queued_ms(fn, n, evict, cycles):
    """ms between a CUDA event and another around ``n`` calls of ``fn``
    (``fn`` None: none), each after a read of ``evict`` if given, all
    queued behind a hold of ``cycles``; None if the hold ended before the
    host had queued the last call."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    held = torch.cuda.Event()
    torch.cuda._sleep(cycles)
    held.record()
    start.record()
    for _ in range(n):
        if evict is not None:
            evict.sum()   # read: the L2 left clean
        if fn is not None:
            fn()
    end.record()
    queued_in_time = not held.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) if queued_in_time else None


def device_ms(fn, n: int = 10, evict=None) -> float:
    """Device ms a call of ``fn``: the card's time for ``n`` calls queued
    back to back behind a hold (so that it never waits on the host), less
    its time for the same queue without the calls, over ``n``; with
    ``evict`` (a tensor larger than the L2) read before each call in both
    queues. If a hold ended before the host had queued its last call, both
    queues are taken again behind a hold four times as long; raises after
    ``HOLDS``."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = HOLD_CYCLES
    for _ in range(HOLDS):
        with_calls = _queued_ms(fn, n, evict, cycles)
        without = _queued_ms(None, n, evict, cycles)
        if with_calls is not None and without is not None:
            return (with_calls - without) / n
        cycles *= 4
    raise RuntimeError(f"device_ms: the host took longer to queue {n} "
                       f"calls than a hold of {cycles // 4} cycles")
