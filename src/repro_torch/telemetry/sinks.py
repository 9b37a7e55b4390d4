"""Event sinks for :class:`repro_torch.telemetry.Telemetry`.

A sink is anything with ``emit(event: dict)`` and (optionally)
``close()``. Sinks receive finalized HOST events only — plain dicts of
Python scalars (plus the length-K per-agent attribution lists), never
tensors — at chunk boundaries in buffered mode or as each round ends in
streaming mode. Frozen rounds (computed after a hit, then discarded) are
filtered before sinks see anything.
"""
from __future__ import annotations

import json
import sys
from typing import Optional


class MemorySink:
    """Collect events in a list (tests)."""

    def __init__(self):
        self.events = []

    def emit(self, event: dict):
        self.events.append(event)

    def close(self):
        pass


class JsonlSink:
    """One JSON object per line. The file opens lazily on the first
    event and flushes per emit, so a live ``tail -f`` of a streaming run
    sees rounds as they happen."""

    def __init__(self, path):
        self.path = path
        self._fh = None
        self.count = 0

    def emit(self, event: dict):
        if self._fh is None:
            self._fh = open(self.path, "w")
        # allow_nan=False: the emitted log must be strict JSON — a NaN
        # metric would poison downstream schema validation
        self._fh.write(json.dumps(event, allow_nan=False) + "\n")
        self._fh.flush()
        self.count += 1

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ConsoleSink:
    """Compact per-round lines on a stream (default stderr, keeping
    stdout clean for driver output)."""

    def __init__(self, stream=None, every: int = 1):
        self.stream = stream if stream is not None else sys.stderr
        self.every = max(1, int(every))
        self._n = 0

    def emit(self, event: dict):
        self._n += 1
        if (self._n - 1) % self.every:
            return
        d = event.get("driver", "?")
        t = event.get("round", "?")
        if d == "maml":
            body = f"meta_loss={event.get('meta_loss', float('nan')):.6g}"
        else:
            body = (f"J={event.get('joules', 0.0):.4g}"
                    f" edges={event.get('edges', 0)}"
                    f" disagreement={event.get('disagreement', 0.0):.4g}")
        print(f"[telemetry] {d} round={t} {body}", file=self.stream)

    def close(self):
        pass
