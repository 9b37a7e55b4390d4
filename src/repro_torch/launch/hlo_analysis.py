"""Roofline inputs of one step: the port's counterpart of the JAX package's
``launch/hlo_analysis.py``.

The JAX package reads a compiled XLA program: ``cost_analysis()`` FLOPs
and bytes, collective bytes parsed from the optimized HLO text, and
``memory_analysis()``. Eager PyTorch has no such program, so the input
here is the DISPATCH RECORDS of one eager run of the step on ``meta``
tensors (shapes and dtypes, no storage, no compute), at one rank's shapes
on a fake process group (:mod:`repro_torch.launch.dryrun`):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions, attention: 2 flops a multiply-add; elementwise ops count
  none), plus every hand-written kernel call's count from
  :mod:`repro_torch.kernels.work` (the kernels launch through ``ctypes``,
  below the dispatcher, where the counter cannot see them; on ``meta``
  each wrapper reports its call instead). B4 under a causal or window
  mask counts the visible (query, key) pairs it computes; its backward,
  the plain version's vector-Jacobian product, is counted by the counter.
* bytes accessed: each kernel call's count, plus, for every other aten
  op, the bytes of its tensor inputs read and its outputs written, each
  tensor counted once per op at the elements its strides address (a
  broadcast operand at its own size). Views and ``empty`` allocations
  move nothing and count nothing.
* collective bytes: every c10d op (:class:`repro_torch.analysis.
  costmodel.CollectiveRecorder`'s records), by the reference's five
  names (an all-reduce's, all-gather's, reduce-scatter's and
  all-to-all's result bytes; ``send``/``recv_`` are a
  ``collective-permute``, counted once at the receive, whose bytes are
  its peer's send), and split by the mesh axis whose group ran it.
* peak bytes per device: ``torch.distributed._tools.mem_tracker.
  MemTracker`` over the step, the step's params, optimizer state, caches
  and batch included.

As the JAX package does, the report multiplies the per-device numbers by
``chips`` so the roofline formulas (which divide by chips) apply as
written. An eager run counts every op it dispatches, loops over layers
and time included, so there is no scan to correct (no counterpart of
``launch/probes.py``'s probes).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.costmodel import Collective, _tensors, collective_of
from repro_torch.kernels import work

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

#: c10d op names → the reference's collective names (``send`` is counted
#: at its peer's ``recv_``)
C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t``'s strides address (a dim of stride 0,
    a broadcast, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _moves_nothing(func) -> bool:
    """A view (its outputs alias an input without writing it) or an
    uninitialised allocation."""
    name = func._schema.name.split("::")[-1]
    if name.startswith("empty") or name in ("lift_fresh", "detach",
                                            "_to_copy_meta"):
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class StepRecorder(TorchDispatchMode):
    """Within the block, each aten op's bytes, each c10d op (with the mesh
    axis of its group, from ``axes``: ``{group name: axis}``), every
    output's (dtype, shape), and each hand-written kernel call's
    (:mod:`repro_torch.kernels.work`) flops and bytes."""

    def __init__(self, axes: Optional[Dict[str, str]] = None):
        super().__init__()
        self.axes = dict(axes or {})
        self.op_bytes = self.kernel_flops = self.kernel_bytes = 0
        self.kernel_calls: Dict[str, int] = {}
        self.collectives: List[Tuple[str, Collective]] = []
        self.shapes: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            rec = collective_of(func, args)
            axis = "world"
            for a, arg in zip(args, func._schema.arguments):
                if "ProcessGroup" in str(arg.type):
                    axis = self.axes.get(
                        dist.ProcessGroup.unbox(a).group_name, "world")
            self.collectives.append((axis, rec))
            return out
        outs = _tensors(out)
        for t in outs:
            self.shapes.add((_dtype_name(t), tuple(t.shape)))
        if not _moves_nothing(func):
            ins = _tensors(args) + _tensors(list((kwargs or {}).values()))
            self.op_bytes += sum(tensor_bytes(t) for t in ins + outs)
        return out

    def kernel(self, name: str, flops: int, nbytes: int):
        self.kernel_flops += int(flops)
        self.kernel_bytes += int(nbytes)
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    @contextlib.contextmanager
    def recording(self):
        """The dispatch mode and the kernel sink together."""
        with work.counting(self.kernel), self:
            yield self


def collective_bytes(records: Iterable) -> Dict[str, int]:
    """{collective kind: bytes} summed over ``records`` (:class:`repro_torch.
    analysis.costmodel.Collective`, or (axis, Collective) pairs), by the
    reference's five names; ``send`` is skipped (its bytes are its peer's
    ``recv_``), and a c10d op outside :data:`C10D_KINDS` is refused by
    name."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for rec in records:
        if isinstance(rec, tuple) and len(rec) == 2 \
                and isinstance(rec[1], Collective):
            rec = rec[1]
        if rec.kind == "send":
            continue
        if rec.kind not in C10D_KINDS:
            raise ValueError(f"c10d op {rec.kind!r} ({rec.shape}) has no "
                             f"collective name; known: {sorted(C10D_KINDS)}")
        out[C10D_KINDS[rec.kind]] += rec.nbytes
    return out


def collective_bytes_by_axis(records) -> Dict[str, Dict[str, int]]:
    """{mesh axis: {collective kind: bytes}} of (axis, Collective) pairs."""
    axes: Dict[str, list] = {}
    for axis, rec in records:
        axes.setdefault(axis, []).append(rec)
    return {a: {k: v for k, v in collective_bytes(r).items() if v}
            for a, r in axes.items()}


def square_buffers(shapes: Iterable, min_dim: int):
    """Every DISTINCT square tensor shape (D, D) with D >= ``min_dim``
    among ``shapes`` ((dtype name, shape) pairs, as
    :class:`StepRecorder` collects every op's outputs), as ``(dtype, D,
    bytes)`` tuples. The sharded and distributed plans exist so that no
    process materializes the (K, K) mixing stack (rule H1)."""
    seen = set()
    for dt, shape in shapes:
        if len(shape) == 2 and shape[0] == shape[1] and shape[0] >= min_dim:
            size = torch.empty((), dtype=getattr(torch, dt)).element_size()
            seen.add((dt, shape[0], shape[0] * shape[1] * size))
    return sorted(seen)


@dataclass
class DryRunReport:
    """One (arch, shape, mesh) dry run: GLOBAL FLOPs, bytes and collective
    bytes (per device times ``chips``), by axis too, the peak bytes per
    device, and the link bytes/s of each axis."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    hbm_bytes: float
    collectives: Dict[str, int]
    bytes_per_device: Optional[float] = None
    compile_seconds: float = 0.0       # the eager meta run's wall time
    collectives_by_axis: Dict[str, Dict[str, int]] = field(
        default_factory=dict)
    axis_link_bw: Dict[str, float] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)

    @property
    def collective_total(self) -> int:
        return sum(self.collectives.values())

    def link_bw(self) -> float:
        """One link rate for the roofline: the bytes-weighted harmonic
        mean of the axes' rates, so that ``t_collective`` is the sum of
        each axis' bytes over its own rate."""
        from repro_torch.core.energy import H100_SXM

        t = sum(sum(kinds.values()) / self.axis_link_bw.get(a, H100_SXM[
            "ib_bw"]) for a, kinds in self.collectives_by_axis.items())
        total = sum(sum(k.values()) for k in self.collectives_by_axis.values())
        return total / t if t > 0 else H100_SXM["ib_bw"]

    def roofline(self, **kw):
        from repro_torch.core.energy import RooflineTerms

        kw.setdefault("link_bw", self.link_bw())
        return RooflineTerms(flops=self.flops, hbm_bytes=self.hbm_bytes,
                             collective_bytes=float(self.collective_total),
                             chips=self.chips, **kw)


def analyze_compiled(recorder: StepRecorder, flop_counter, peak_bytes, *,
                     arch: str, shape: str, mesh_name: str, chips: int,
                     axis_link_bw: Optional[Dict[str, float]] = None,
                     compile_seconds: float = 0.0) -> DryRunReport:
    """The report of one step's dispatch records (the JAX package's
    ``analyze_compiled`` reads a compiled program instead):
    ``recorder`` (:class:`StepRecorder`), ``flop_counter`` (the
    ``FlopCounterMode`` of the same run) and ``peak_bytes`` (this
    device's peak, from ``MemTracker``). Per-device numbers are
    multiplied by ``chips`` (GLOBAL totals), collectives included."""
    flops = float(flop_counter.get_total_flops() + recorder.kernel_flops)
    hbm = float(recorder.op_bytes + recorder.kernel_bytes)
    by_axis = {a: {k: v * chips for k, v in kinds.items()}
               for a, kinds in collective_bytes_by_axis(
                   recorder.collectives).items()}
    colls = {k: v * chips for k, v in collective_bytes(
        recorder.collectives).items()}
    return DryRunReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=flops * chips, hbm_bytes=hbm * chips, collectives=colls,
        bytes_per_device=None if peak_bytes is None else float(peak_bytes),
        compile_seconds=compile_seconds, collectives_by_axis=by_axis,
        axis_link_bw=dict(axis_link_bw or {}),
        kernel_calls=dict(recorder.kernel_calls))
