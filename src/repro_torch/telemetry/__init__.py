"""repro_torch.telemetry — per-round energy/comms/convergence metrics out
of the chunked round drivers.

The drivers (``federated.run_fl_until_scan``, ``maml.maml_train_scan``,
``engine.scan_rounds``, the case study) run ``chunk`` rounds between two
reads of the device, and this package keeps that: every round builds one
fixed-shape row of tensors (:class:`~repro_torch.telemetry.buffer
.RoundRecorder`), and the rows ride the read the driver already makes at
the chunk's end, where they are priced (Eq.-(11) joules by UL/DL/SL class,
wire bits, per-agent joules) in float64 and appended to the
:class:`~repro_torch.telemetry.buffer.MetricBuffer`. Two modes:

**buffered** (default) — one device→host read per chunk, as without
telemetry; live rounds reach the sinks at the chunk's end.

**streaming** — each round's row is read as soon as the round's replay
ends (one device→host read per round computed) and a live round goes to
the sinks then, while the chunk is still running. The JAX package emits
from inside its compiled chunk with ``jax.debug.callback``; here the row
is a static output of the round's CUDA graph, read after each replay, so
the read per round is the price of liveness. Streaming round programs
are built per call and never cached, as in the JAX package.

In both modes the buffer is filled once per chunk and holds the same
events, and round results are bit-identical with telemetry off, buffered
or streaming: rows READ the round state, they never feed back into it.

Sinks (:mod:`~repro_torch.telemetry.sinks`) are pluggable: in-memory for
tests, a JSONL event log (checked by ``python -m
repro_torch.telemetry.schema``), console. On an engine whose agents are
spread over a process group every rank's buffer holds the same events,
and only the agent axis's rank 0 emits them to the sinks, so one log
exists, as from the JAX package's single controller. ``report()`` adds the kernels'
launch counters and the program cache
(:func:`~repro_torch.telemetry.report.harness_report`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import energy, scanloop
from repro_torch.telemetry.buffer import (MetricBuffer, RoundRecorder,
                                          consensus_disagreement, ROW_FIELDS)
from repro_torch.telemetry.report import harness_report
from repro_torch.telemetry.schema import validate_event, validate_jsonl
from repro_torch.telemetry.sinks import ConsoleSink, JsonlSink, MemorySink

__all__ = [
    "Telemetry", "MetricBuffer", "RoundRecorder", "ROW_FIELDS",
    "consensus_disagreement", "harness_report",
    "validate_event", "validate_jsonl",
    "MemorySink", "JsonlSink", "ConsoleSink",
]

MODES = ("buffered", "streaming")


def _speaks(recorder: RoundRecorder) -> bool:
    """Whether this process emits ``recorder``'s rounds to the sinks:
    always without a mesh; on a meshed engine only the agent axis's rank
    0 (every rank records the same rows)."""
    eng = recorder.engine
    return (getattr(eng, "local_rows", None) is None
            or eng.mesh.get_local_rank(eng.plan.axis_name) == 0)


class Telemetry:
    """Run-scoped telemetry configuration + collected events.

    One instance is threaded through a driver (or ``MTLProtocol`` /
    ``CaseStudy``); every chunk lands its rounds here. ``mode`` picks the
    contract described in the module docstring; ``energy_params`` prices
    the ledger (defaults to the paper's Fig.-3 calibration); ``capacity``
    bounds the in-memory ring buffer.
    """

    def __init__(self, mode: str = "buffered", sinks=(),
                 energy_params=None, capacity: Optional[int] = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.sinks = tuple(sinks)
        self.energy_params = (energy_params
                              or energy.paper_calibrated("fig3"))
        self.buffer = MetricBuffer(capacity)
        self._recorders: dict = {}      # id(engine) -> (engine, recorder)

    @property
    def streaming(self) -> bool:
        return self.mode == "streaming"

    def trace_signature(self) -> tuple:
        """What this instance bakes into a driver's captured round
        program: part of the ``cached_program`` key for buffered programs
        (their row outputs change the round, so they must not collide
        with telemetry-off entries). Streaming programs never reach a
        cache key: the drivers build them per call, uncached."""
        return ("telemetry", self.mode)

    # -- recorders ------------------------------------------------------

    def recorder_for(self, engine, energy_params=None) -> RoundRecorder:
        """The per-engine :class:`RoundRecorder` (memoized by engine
        identity, so the row maker and the host pricer agree).
        ``energy_params`` overrides this instance's pricing for the
        recorder CREATED here (first creation wins) — orchestrators like
        ``CaseStudy`` pre-register their engines with their own billing
        constants so the stream reconciles with their post-hoc ledger."""
        hit = self._recorders.get(id(engine))
        if hit is not None and hit[0] is engine:
            return hit[1]
        rec = RoundRecorder(engine, energy_params or self.energy_params)
        self._recorders[id(engine)] = (engine, rec)
        return rec

    # -- host ingestion (once per chunk) --------------------------------

    def record_rounds(self, recorder: RoundRecorder, rows, start,
                      driver: str = "fl", extra: Optional[dict] = None):
        """Finalize one chunk's stacked rows into events: price, append
        to the buffer, and (buffered mode) emit live rounds to sinks —
        streaming mode already emitted them as each round ended, so here
        it only fills the buffer. On a mesh only the agent axis's rank 0
        emits (:func:`_speaks`)."""
        events = recorder.finalize(rows, int(start), driver=driver,
                                   extra=extra)
        self.buffer.extend(events)
        if not self.streaming and _speaks(recorder):
            for e in events:
                if e["live"]:
                    self._emit(e)
        return events

    def record_maml_rounds(self, metrics, start,
                           extra: Optional[dict] = None):
        """Meta-training rounds from a chunk's stacked metrics dict
        (``meta_loss`` required; ``meta_grad_norm`` optional)."""
        loss = np.asarray(metrics["meta_loss"])
        gn = metrics.get("meta_grad_norm")
        gn = None if gn is None else np.asarray(gn)
        events = []
        for i in range(loss.shape[0]):
            e = {"type": "round", "driver": "maml",
                 "round": int(start) + i, "live": True,
                 "meta_loss": float(loss[i])}
            if gn is not None:
                e["meta_grad_norm"] = float(gn[i])
            if extra:
                e.update(extra)
            events.append(e)
        self.buffer.extend(events)
        if not self.streaming:
            for e in events:
                self._emit(e)
        return events

    # -- streaming (called as each round ends) --------------------------

    def stream_cb(self, recorder: RoundRecorder, driver: str = "fl",
                  extra: Optional[dict] = None):
        """Host function ``cb(t, row)`` the drivers call after each round
        in streaming mode: reads the row (one device→host copy), prices
        it and emits it to the sinks if it is live. The buffer is NOT
        filled here (the chunk-end :meth:`record_rounds` does that in both
        modes, keeping buffer contents identical across modes). On a mesh
        only the agent axis's rank 0 emits."""
        speaks = _speaks(recorder)

        def cb(t, row):
            e = recorder.event(int(t), row, driver=driver, extra=extra)
            if e["live"] and speaks:
                self._emit(e)
        return cb

    def maml_stream_cb(self, extra: Optional[dict] = None):
        """Host function ``cb(t, meta_loss, meta_grad_norm)`` for the
        meta-training rounds in streaming mode (one device→host copy)."""
        def cb(t, meta_loss, meta_grad_norm):
            loss, gn = scanloop.to_host(torch.stack([meta_loss,
                                                     meta_grad_norm]))
            e = {"type": "round", "driver": "maml", "round": int(t),
                 "live": True, "meta_loss": float(loss),
                 "meta_grad_norm": float(gn)}
            if extra:
                e.update(extra)
            self._emit(e)
        return cb

    def _emit(self, event: dict):
        for sink in self.sinks:
            sink.emit(event)

    # -- reading back ---------------------------------------------------

    def events(self, live_only: bool = True, driver: Optional[str] = None):
        out = self.buffer.rows(live_only=live_only)
        if driver is not None:
            out = [e for e in out if e.get("driver") == driver]
        return out

    def joules(self, driver: str = "fl",
               task_id: Optional[int] = None) -> float:
        """Summed per-round Eq.-(11) ledger over live rounds — plain
        left-to-right ``sum`` of the float64 stream, so under identical
        masks it equals the post-hoc replay
        (``ProtocolResult.fl_comm_joules_measured``) EXACTLY."""
        return sum(e["joules"] for e in self.events(driver=driver)
                   if task_id is None or e.get("task_id") == task_id)

    def report(self) -> dict:
        """Run summary + the kernels' launch counters and the program
        cache (see :func:`repro_torch.telemetry.report.harness_report`)."""
        live = self.buffer.rows(live_only=True)
        out = {
            "mode": self.mode,
            "events": len(self.buffer),
            "live_rounds": len(live),
            "dropped": self.buffer.dropped,
            "joules": sum(e.get("joules", 0.0) for e in live),
            "wire_bits": sum(e.get("wire_bits", 0.0) for e in live),
        }
        out.update(harness_report())
        return out

    # -- lifecycle ------------------------------------------------------

    def reset(self):
        """Drop collected events (recorders and sinks stay)."""
        self.buffer.clear()

    def close(self):
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()
