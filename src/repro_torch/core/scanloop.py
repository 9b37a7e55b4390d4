"""The compiled chunk program of the round drivers: the port's counterpart
of the JAX package's ``core/scanloop.py``.

The paper's energy balance is measured in ROUNDS (t0 meta rounds, t_i
adaptation rounds per task), so Monte-Carlo sweeps run tens of thousands
of them, and an eager round pays a Python dispatch per kernel: an FL
round of the case study issues about 5,300 launches for about 11 ms of
device work. The JAX package compiles ``chunk`` rounds into one XLA
program; here a round of fixed shapes is recorded ONCE as a CUDA graph
(``torch.cuda.CUDAGraph``) and replayed with one host call a round. The
drivers still read the device once per chunk. The pieces:

* :func:`donating_graph` — the counterpart of ``donating_jit``. On the
  card the first call of each argument signature (a *variant*) runs
  ``fn`` eagerly on a side stream, on the inputs the graph will read:
  that run IS the call (its carry lands in the donated buffers, its
  ``ys`` and generator states are the call's), and its first-use work
  (library loads, cached device tables, cuBLAS workspaces) happens there,
  never inside the capture. Then one call of ``fn`` is captured into a
  graph with static input and output buffers, without being replayed;
  later calls copy their arguments into the static inputs and replay.
  DONATION: ``fn`` returns
  ``(carry, ys)``, ``carry`` holding one new value per donated argument;
  the graph writes each donated leaf back into its static input buffer,
  so the carry is updated in place round after round and a call whose
  donated arguments ARE those buffers copies nothing. ``fn`` may also
  write the new carry into the donated buffers itself (``copy_``, as the
  training steps do: no second copy of a model inside the graph). The
  DONATION
  INVARIANT: a donated argument is dead after the call (the first capture
  adopts its tensors as the buffers). The drivers :func:`own` a caller's
  pytree before the first round, so the caller's params stay valid across
  driver calls, and copy the carry out once at the end. ``ys`` of a
  replay live in
  the program's own graph memory pool, shared by its variants, and are
  valid until its next replay: the drivers copy them out at once. A
  ``torch.Generator`` argument is replaced inside the graph by the
  program's own registered generator, whose state is synced from and back
  to the caller's around every replay, so the caller's generator ends in
  the eager run's state. Each program captures into its own graph memory
  pool, and returns the allocator's cached blocks to the card before a
  capture (PyTorch releases none while one is underway, so a capture
  could fail for memory a dead program's pool still caches). Replays
  add the kernel wrappers' launches made during the capture to their
  ``launches`` counters. On the CPU and under
  :func:`uncaptured` nothing is captured: a call runs ``fn`` eagerly,
  keyed, cached and counted the same way.
* :func:`traceable` — the capture probe: ``fn(*probe_args)`` runs once
  under a dispatch mode that follows which tensors depend on the inputs,
  leaving the generators as they were. A function that
  reads a tensor on the host (``.item()``, ``bool(t)``, ``int(t)``,
  numpy), or whose outputs do not depend on its inputs (a host RNG's
  constants, ``next(iterator)``), fails; the drivers then call it eagerly
  before each replay and copy its outputs into the graph's static inputs
  (``jax.pure_callback``'s counterpart), and never admit its program to
  the cache.
* :func:`cached_program` — the program cache, an LRU of
  :data:`PROGRAM_CACHE_SIZE` entries keyed on everything a capture bakes
  in (the round functions by identity, the engine, the scalars, the
  carry's :func:`tree_signature`), and capped at
  :data:`PROGRAM_CACHE_BYTES` of device memory held between driver calls
  (:func:`trim_program_cache`). :data:`TRACE_COUNTS` counts the
  variants built per driver family (``"fl_chunk"``, ``"maml_chunk"``):
  captures on the card, builds on the CPU.
* THE BYTE RULE. A program HELD across calls (admitted to
  :func:`cached_program`, or held by its engine: ``cache_key`` set) whose
  graphs would hold more than
  :data:`PROGRAM_CACHE_BYTES` on their own is never replayed: it becomes
  an EAGER program for good (:data:`OVER_BYTE_CAP`), decided once per
  program, before its first capture where :func:`held_bytes_lower_bound`
  (its carry and static inputs, from their shapes) already exceeds the
  cap, else when its first capture has measured ``held_bytes``, whose
  graph and pool are then freed. It keeps its place in the cache, so
  later calls of its key hit, probe nothing, capture nothing and run
  the round eagerly. The rule is decided on every device (the CPU runs
  eagerly anyway, but says why), never under :func:`uncaptured`. A
  program built and dropped within one call (the launchers' programs,
  :mod:`repro_torch.launch`, as the JAX package's launchers build their
  ``jax.jit`` programs per call; the drivers' streaming and host-function
  programs) holds nothing between calls and is never under the rule;
  ``cache_stats()["per_call_held_bytes"]`` reports what the live ones
  hold.
* KEPT ARGUMENTS. ``keep_argnums`` names arguments a program only
  reads, such as served params: the capture uses the caller's own
  tensors (or module) as static inputs, by reference, with no clone, so
  a replay reads them in place as ``jax.jit`` reads a non-donated
  argument. A replay handed another object, or a kept tensor whose
  storage moved, raises naming the program and the leaf (copying into
  the captured tensor would overwrite the caller's). The program does
  not own them: ``held_bytes`` and :func:`held_bytes_lower_bound` count
  them as 0.
* COLLECTIVES. A meshed round's body issues c10d collectives on its
  process group (``donating_graph(group=)``: the consensus wire, the
  population gather, telemetry's all-reduces). On an NCCL group they are
  captured with the rest of the round: the communicator was set up by
  the variant's first call, which runs eagerly before the capture, and
  the capture runs in ``"thread_local"`` mode whenever a process group
  is live (its watchdog thread queries CUDA events meanwhile). A group
  whose backend joins no CUDA graph (gloo, on CUDA tensors) runs the
  program eagerly, ``why_uncaptured`` naming the backend; on the CPU it
  runs eagerly as every program does. A dispatch mode sees a call's
  collectives as they run: the first call's eagerly; the capture's
  dispatch is hidden from every active mode; each replay hands the ops
  its capture recorded (``ProgramRecord.collectives_per_replay``) to the
  active modes that take them (``replayed``, as
  ``repro_torch.analysis.costmodel.CollectiveRecorder`` does), so a
  captured run records what the same run records under
  :func:`uncaptured`. Every rank must decide alike where a decision
  changes the collectives it issues: the byte rule predicts from shapes
  (the same on every rank for equal blocks) and, after a capture, takes
  the largest ``held_bytes`` over the group (:func:`agree`: one int64
  all-reduce outside every dispatch mode).
* :func:`built_programs` collects the records of the programs a block
  builds, for audits and tests of programs that die with their call.
* :func:`first_hit` and :func:`to_host` — t_i from a chunk's reached
  flags, and the drivers' one device→host read of a chunk.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

#: the kernel wrappers whose ``launches`` counters replays advance
#: (:mod:`repro_torch.kernels.ops`, in the kernel table's order)
COUNTED_KERNELS = ("quant_consensus_pop", "consensus_update_pop",
                   "rglru_scan", "flash_attention", "rglru_scan_backward",
                   "flash_attention_backward")


def _ops():
    from repro_torch.kernels import ops
    return ops


def launch_counts() -> dict:
    """Every counted kernel wrapper's ``launches``, by name."""
    ops = _ops()
    return {n: getattr(ops, n).launches for n in COUNTED_KERNELS}


def _set_launch_counts(counts: dict):
    ops = _ops()
    for n, v in counts.items():
        getattr(ops, n).launches = v


@dataclasses.dataclass
class ProgramRecord:
    """Audit-facing record of one :func:`donating_graph` program.

    ``python -m repro_torch.analysis --layer programs`` walks
    :func:`registered_programs`: no admitted program (``cache_key`` set)
    may hold a function that failed the probe (``host_fns``, JX1) or
    stream telemetry (``streaming``, JX4); the replays of a captured
    program must honour donation (``in_place``, JX3); and an argument
    holding the ``AsyncState`` must be donated (``async_argnums`` within
    ``donate_argnums``, JX5)."""
    name: str
    fn: Callable
    donate_argnums: tuple
    #: arguments read in place, never cloned or owned (module docstring)
    keep_argnums: tuple = ()
    #: whether any variant has been captured into a CUDA graph
    captured: bool = False
    #: why calls run eagerly ("cpu", "uncaptured()"), None while every
    #: call replays
    why_uncaptured: Optional[str] = None
    cache_key: Optional[tuple] = None       # set on cached_program admit
    #: names of the round functions that failed the probe and run eagerly
    #: before each replay
    host_fns: tuple = ()
    streaming: bool = False
    #: kernel launches of one replay, by wrapper, per variant label
    launches_per_replay: dict = dataclasses.field(default_factory=dict)
    #: the c10d ops one replay issues, by name in order, per variant label
    #: (a program whose body runs collectives on ``group``)
    collectives_per_replay: dict = dataclasses.field(default_factory=dict)
    #: the backend of the process group the body's collectives run on
    #: (``donating_graph(group=)``), None for a one-process program
    group_backend: Optional[str] = None
    #: a capture's call is its variant's first call, run eagerly just
    #: before the capture; every later call of the variant replays
    captures: int = 0
    replays: int = 0
    #: the captures alone, not the first calls they follow
    capture_seconds: float = 0.0
    #: calls that ran ``fn`` eagerly (the CPU, :func:`uncaptured`, the
    #: byte rule)
    eager_calls: int = 0
    #: the arguments that hold the async protocol's ``AsyncState`` (the
    #: per-agent clocks and per-lane wire ages)
    async_argnums: tuple = ()
    #: device bytes the program holds between calls: its donated carry
    #: buffers, its static inputs and its graph pool's segments (0 until a
    #: capture, and on the CPU) — what :data:`PROGRAM_CACHE_BYTES` caps
    held_bytes: int = 0
    #: under the byte rule (``why_uncaptured ==`` :data:`OVER_BYTE_CAP`):
    #: the bytes that put it above the cap, predicted or measured
    over_cap_bytes: int = 0
    #: donation honoured so far: False once a replay found a donated
    #: buffer moved from the address its graph writes, or was handed back
    #: its own previous carry as something other than those buffers (a
    #: copy into the buffers every round); None before any replay
    in_place: Optional[bool] = None


#: weakrefs to live programs: entries vanish with their program (LRU
#: eviction, driver or instance GC), so the registry never extends a
#: graph's lifetime
_PROGRAM_REFS: list = []

#: ``ProgramRecord.why_uncaptured`` of a program under the byte rule
OVER_BYTE_CAP = "held_bytes above PROGRAM_CACHE_BYTES"

#: the lists :func:`built_programs` blocks collect records into
_COLLECTING: list = []


def _live_programs():
    """Every :func:`donating_graph` program still referenced. Dead
    weakrefs are pruned in passing."""
    out, alive = [], []
    for ref in _PROGRAM_REFS:
        p = ref()
        if p is not None:
            alive.append(ref)
            out.append(p)
    _PROGRAM_REFS[:] = alive
    return out


def registered_programs():
    """Live :class:`ProgramRecord`\\ s of every :func:`donating_graph`
    program still referenced (program cache, drivers, case studies,
    engines)."""
    return [p.record for p in _live_programs()]


def clear_program_registry():
    """Forget every registered program (tests)."""
    _PROGRAM_REFS.clear()


@contextlib.contextmanager
def built_programs():
    """Collect the :class:`ProgramRecord` of every program built inside the
    block, in order, into the list it yields. The records outlive their
    programs (a launcher's programs die with its call), and hold no graph
    or device buffer of their own."""
    records = []
    _COLLECTING.append(records)
    try:
        yield records
    finally:
        # by identity: an enclosing block's list may hold equal records
        del _COLLECTING[next(i for i, r in enumerate(_COLLECTING)
                             if r is records)]


_UNCAPTURED = [0]


@contextlib.contextmanager
def uncaptured():
    """Run every :func:`donating_graph` program eagerly on the card: the
    same drivers, arguments and order of operations, with no graph. The
    counterpart of ``jax.disable_jit``, for tests and the smoke's ``==``
    checks only."""
    _UNCAPTURED[0] += 1
    try:
        yield
    finally:
        _UNCAPTURED[0] -= 1


def own(tree):
    """A driver-owned copy of a CALLER-provided pytree of tensors on the
    card (the identity on the CPU, where nothing is captured or donated).
    The drivers own incoming params before the first round, so donation
    consumes only driver-owned buffers and the caller's pytree stays valid
    across driver calls; they own the carry again on the way out, so the
    params they return outlive the program's next replay."""
    leaves, spec = tree_flatten(tree)
    if not any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
               for x in leaves):
        return tree
    return tree_unflatten([x.clone() if isinstance(x, torch.Tensor) else x
                           for x in leaves], spec)


def _leaf_signature(x, kept=False):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, torch.Generator):
        return ("G", str(x.device))
    if kept:
        # a kept module is read by reference: another object of its type
        # is the same signature, refused at replay
        return ("K", type(x).__name__)
    return ("C", type(x).__name__, x)


def _kept_storage(x):
    """The storage addresses a graph captured with the kept leaf ``x``
    reads: its own, or every parameter's and buffer's of a module."""
    if isinstance(x, torch.Tensor):
        return (x.data_ptr(),)
    if isinstance(x, torch.nn.Module):
        return tuple(t.data_ptr() for t in (*x.parameters(), *x.buffers()))
    return ()


def _arg_positions(args, argnums):
    """Flat leaf positions of the arguments ``argnums``, in order."""
    pos, start = [], 0
    for i, a in enumerate(args):
        n = len(tree_flatten(a)[0])
        if i in argnums:
            pos.extend(range(start, start + n))
        start += n
    return pos


def tree_signature(tree):
    """Hashable (treespec, ((shape, dtype), …)) signature of a pytree —
    the shapes/dtypes part of a program-cache key (non-tensor leaves by
    type and value)."""
    leaves, spec = tree_flatten(tree)
    return (spec, tuple(
        (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
        else (type(x).__name__, x) for x in leaves))


# -- the capture probe ---------------------------------------------------------

class _HostRead(RuntimeError):
    """Raised by the capture probe where a function reads a tensor on the
    host."""


#: ops that hand a tensor's value to the host: the probe's failures
_HOST_READS = ("aten._local_scalar_dense", "aten.item")


def _probe_outputs_depend(fn, probe_args) -> bool:
    """Run ``fn(*probe_args)`` once and say whether any output tensor
    depends on an input: a tensor argument, or a draw from a generator
    argument. Raises :class:`_HostRead` where ``fn`` reads a tensor's
    value on the host (``.item()``, ``int(t)``, ``bool(t)``, a copy off
    the card), and whatever else ``fn`` raises.

    The call is real (fake tensors would leave fake entries in the device
    caches ``fn`` may fill on first use), and leaves no trace: the
    generator arguments, the default generators and the kernels' launch
    counters are restored after it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    keep = []                            # dependent tensors, kept alive
    ids, ptrs = set(), set()
    # the dispatcher hands ops new Python wrappers of a generator: compare
    # the C++ generator
    gens = {x._cdata for x in tree_flatten(probe_args)[0]
            if isinstance(x, torch.Generator)}

    def mark(t):
        keep.append(t)
        ids.add(id(t))
        if t.numel():
            ptrs.add(t.untyped_storage().data_ptr())

    def depends(t):
        return id(t) in ids or (t.numel() and t.layout == torch.strided
                                and t.untyped_storage().data_ptr() in ptrs)

    class Track(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func.overloadpacket)
            if name in _HOST_READS:
                raise _HostRead(f"{func} reads a tensor on the host")
            flat, _ = tree_flatten((args, kwargs))
            if name in ("aten._to_copy", "aten.copy_") and any(
                    isinstance(a, torch.Tensor) and a.device.type != "cpu"
                    for a in flat) and (
                    kwargs.get("device") == torch.device("cpu")
                    or (name == "aten.copy_" and args[0].device.type
                        == "cpu")):
                raise _HostRead(f"{func} copies a tensor to the host")
            out = func(*args, **kwargs)
            if any((isinstance(a, torch.Tensor) and depends(a))
                   or (isinstance(a, torch.Generator) and a._cdata in gens)
                   for a in flat):
                for o in tree_flatten(out)[0]:
                    if isinstance(o, torch.Tensor):
                        mark(o)
            return out

    flat = tree_flatten(probe_args)[0]
    states = [(g, g.get_state()) for g in flat
              if isinstance(g, torch.Generator)]
    cpu_state = torch.random.get_rng_state()
    cuda_states = (torch.cuda.get_rng_state_all()
                   if torch.cuda.is_available() and torch.cuda.is_initialized()
                   else None)
    counts = launch_counts()
    for x in flat:
        if isinstance(x, torch.Tensor):
            mark(x)
    try:
        with Track():
            out = fn(*probe_args)
        return any(isinstance(o, torch.Tensor) and depends(o)
                   for o in tree_flatten(out)[0])
    finally:
        # ``Track`` is a class made per call, so it lives in a reference
        # cycle until the garbage collector runs: let go of the tensors
        # its closure holds now
        keep.clear()
        ids.clear()
        ptrs.clear()
        for g, st in states:
            g.set_state(st)
        torch.random.set_rng_state(cpu_state)
        if cuda_states is not None:
            torch.cuda.set_rng_state_all(cuda_states)
        _set_launch_counts(counts)


def traceable(fn: Callable, *probe_args, name: str = "sampler"):
    """``(fn, verdict)``: whether ``fn`` may run inside a captured round.

    ``fn(*probe_args)`` is called once under a dispatch mode that follows
    which tensors derive from the arguments (the generators and the
    launch counters are restored afterwards): success — with outputs that
    DEPEND on a tensor argument or on a draw from a generator argument —
    means ``fn`` keeps to the captured contract (device ops only, no host
    read of the round index or of any tensor) and it runs inside the
    graph. Everything else fails: functions that read a tensor on the host
    (``.item()``, ``bool(t)``, ``int(t)``, a copy to the host, numpy) or
    raise, and functions whose outputs are constants (a host RNG's arrays,
    ``next(iterator)``, cached tensors), which a graph would replay as the
    one batch it recorded. As in the JAX package, the probe's call
    consumes an element of a stateful sampler. The drivers call a failed
    function eagerly each round, with the arguments the host loop would
    pass, and copy its outputs into the graph's static inputs: results
    are unchanged, the round only pays that function's dispatch. ``fn``
    is returned unchanged either way; ``name`` is the JAX package's label
    of its callback wrapper, accepted and unused."""
    del name
    try:
        return fn, _probe_outputs_depend(fn, probe_args)
    except Exception:
        return fn, False


# -- donating_graph ------------------------------------------------------------

#: one capture stream per device
_STREAMS: dict = {}


def _capture_stream(device):
    key = str(device)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(device=device)
    return _STREAMS[key]


def _abandon_capture(device, pool):
    """After a capture the card invalidated (``capture_end`` raised before
    the allocator stopped routing the capture stream's allocations to
    ``pool``): stop the routing where this torch exposes it, and retire
    the stream, so no later allocation lands in the abandoned pool."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    for name in ("_cuda_endAllocateToPool",
                 "_cuda_endAllocateCurrentStreamToPool"):
        end = getattr(torch._C, name, None)
        if end is not None:
            try:
                end(index, pool)
                break
            except Exception:
                pass
    _STREAMS.pop(str(device), None)


def _tensor_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for x in tensors:
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def held_bytes_lower_bound(args, donate_argnums=(), keep_argnums=()) -> int:
    """The least device bytes a program capturing one call of ``args``
    holds between calls, from the tensors' shapes and dtypes alone: the
    donated carry, which the capture adopts (each tensor once), and a
    clone of every other tensor argument, its static inputs. Kept
    arguments (``keep_argnums``) are the caller's and count 0. The graph
    pool's segments come on top and are known only once a capture has
    measured them (``ProgramRecord.held_bytes``)."""
    total, seen = 0, set()
    for i, a in enumerate(args):
        if i in keep_argnums:
            continue
        for x in tree_flatten(a)[0]:
            if not isinstance(x, torch.Tensor):
                continue
            if i in donate_argnums:
                if id(x) in seen:
                    continue
                seen.add(id(x))
            total += x.numel() * x.element_size()
    return total


def _meta_like(x):
    """``x`` with every tensor replaced by an empty tensor of its shape and
    dtype on the ``meta`` device (what a record of the op reads)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_meta_like(i) for i in x)
    return x


class _LastOp:
    """Names the last aten op dispatched while a graph is captured, so a
    capture failure says which op the graph refused, and keeps the c10d
    ops the capture dispatched (``collectives``: ``(op, args)`` with the
    tensors as ``meta`` tensors), which every replay issues again."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        box = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                box.last = str(func)
                if func.namespace == "c10d":
                    box.collectives.append((func, _meta_like(tuple(args))))
                return func(*args, **(kwargs or {}))

        self.last = "no aten op yet"
        self.collectives = []
        self.mode = Mode()


def _hand_to_recorders(collectives):
    """Hand the c10d ops a replay issued to every active dispatch mode that
    takes them (``replayed(collectives)``, as
    ``repro_torch.analysis.costmodel.CollectiveRecorder`` does): a replay
    dispatches no op, so a recorder would otherwise miss its collectives."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        take = getattr(mode, "replayed", None)
        if take is not None:
            take(collectives)


def _group_backend(group) -> str:
    """The backend name of a process group (``"nccl"``, ``"gloo"``)."""
    return str(torch.distributed.get_backend(group)).lower()


def agree(group, values, op: str = "min") -> list:
    """``values`` (ints or bools) reduced elementwise over the ranks of
    ``group`` (``op`` "min" or "max"): ONE int64 all-reduce, so that every
    rank takes the same decision (a probe's verdict, the byte rule). It
    runs outside every active dispatch mode, so a collective recorder
    sees only the run's own collectives, captured or not; its payload is
    an int64 control word, never model data."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes

    device = (torch.device("cuda", torch.cuda.current_device())
              if "nccl" in _group_backend(group) else torch.device("cpu"))
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=device)
    with _disable_current_modes():
        dist.all_reduce(t, op=dist.ReduceOp.MIN if op == "min"
                        else dist.ReduceOp.MAX, group=group)
    return [int(v) for v in t.tolist()]


def _write_carry(fn_name, buffers, carry_out):
    """Write ``fn``'s new carry into the donated buffers (a leaf that IS
    its buffer, written in place by ``fn``, is left as it is)."""
    out_flat = tree_flatten(carry_out)[0]
    if len(out_flat) != len(buffers):
        raise ValueError(f"{fn_name} returned {len(out_flat)} carry leaves "
                         f"for {len(buffers)} donated ones")
    for buf, new in zip(buffers, out_flat):
        if isinstance(buf, torch.Tensor) and new is not buf:
            buf.copy_(new)


class _Variant:
    """One captured signature of a program: the graph, its static inputs
    (flattened like the arguments), its outputs and the launches its
    capture recorded."""

    def __init__(self, label, donated, carry):
        self.label = label
        self.donated = donated  # flat positions of the donated leaves
        self.carry = carry      # their buffers, shared across variants
        #: the buffers' addresses the graph writes (None: not a tensor)
        self.carry_ptrs = [b.data_ptr() if isinstance(b, torch.Tensor)
                           else None for b in carry]
        self.graph = None
        self.static = None
        self.ys = None
        self.ys_spec = None
        self.launches = {}
        #: the c10d ops of one replay (``_LastOp.collectives``)
        self.collectives = []
        self.gens = []          # (argument position, private generator)
        #: (flat position, storage addresses) of the kept leaves
        self.kept = []


class Program:
    """A :func:`donating_graph` program (see the module docstring)."""

    def __init__(self, fn, donate_argnums=(), name=None, count_traces=True,
                 keep_argnums=(), group=None):
        self.fn = fn
        #: the process group the body's collectives run on (None: none)
        self.group = group
        self.donate_argnums = tuple(donate_argnums)
        self.keep_argnums = tuple(keep_argnums)
        if set(self.keep_argnums) & set(self.donate_argnums):
            raise ValueError(f"arguments {self.keep_argnums} kept and "
                             f"{self.donate_argnums} donated overlap")
        self.name = name or getattr(fn, "__name__", repr(fn))
        self.count_traces = count_traces
        self.record = ProgramRecord(self.name, fn, self.donate_argnums,
                                    self.keep_argnums)
        if group is not None:
            self.record.group_backend = _group_backend(group)
        self._variants = {}
        self._carry = {}        # donated args' signature -> their buffers
        self._seen = set()      # variant signatures built (TRACE_COUNTS)
        #: the program's graph memory pool, shared by its variants (they
        #: replay one at a time, and their outputs are copied out before
        #: the next replay); it dies with the program
        self._pool = None
        self._pool_bytes = 0
        self._static_bytes = 0
        #: weakrefs to the donated leaves the last replay handed out
        self._handed = None

    # -- signature and mode ---------------------------------------------------
    def _device(self, flat):
        for x in flat:
            if isinstance(x, torch.Tensor):
                return x.device
        return torch.device("cpu")

    def __call__(self, *args):
        flat, spec = tree_flatten(args)
        kept = (set(_arg_positions(args, self.keep_argnums))
                if self.keep_argnums else ())
        sig = (spec, tuple(_leaf_signature(x, i in kept)
                           for i, x in enumerate(flat)))
        new = sig not in self._seen
        if new:
            self._seen.add(sig)
            if self.count_traces:
                TRACE_COUNTS[self.name] += 1
        rec = self.record
        if rec.why_uncaptured == OVER_BYTE_CAP:
            return self._eager(OVER_BYTE_CAP, args)
        device = self._device(flat)
        if _UNCAPTURED[0]:
            return self._eager("uncaptured()", args)
        variant = self._variants.get(sig)
        held = rec.cache_key is not None
        if variant is None and held and (new or device.type == "cuda"):
            # the byte rule, before a capture: the carry and static inputs
            # alone, beside what the program's other variants hold
            predicted = (held_bytes_lower_bound(args, self.donate_argnums,
                                                self.keep_argnums)
                         + rec.held_bytes)
            if _above_cap(predicted):
                self.make_eager(predicted)
                return self._eager(OVER_BYTE_CAP, args)
        if device.type != "cuda":
            return self._eager(device.type, args)
        if self.group is not None and "nccl" not in rec.group_backend:
            # only NCCL's collectives join a CUDA graph
            return self._eager(f"collectives on a {rec.group_backend} group",
                               args)
        if variant is None:
            variant, out = self._capture(args, flat, spec, sig)
            if held and _above_cap(rec.held_bytes):
                # measured by the capture: the graph is never replayed,
                # and this call ran eagerly before it
                self.make_eager(rec.held_bytes)
                rec.eager_calls += 1
                return out
            self._variants[sig] = variant
            trim_program_cache()
            return out
        return self._replay(variant, args, flat)

    def _eager(self, why, args):
        self.record.eager_calls += 1
        if not self.record.captured:
            self.record.why_uncaptured = why
        return self.fn(*args)

    def make_eager(self, nbytes: int):
        """Put the program under the byte rule for good: free its graphs,
        static inputs, carry buffers and pool, and record why and the
        ``nbytes`` that put it above :data:`PROGRAM_CACHE_BYTES`. Every
        later call runs ``fn`` eagerly; a cache entry holding it stays."""
        rec = self.record
        had_graphs = bool(self._variants)
        self._variants.clear()
        self._carry.clear()
        self._pool = None
        self._pool_bytes = self._static_bytes = 0
        self._handed = None
        rec.captured = False
        rec.why_uncaptured = OVER_BYTE_CAP
        rec.over_cap_bytes = int(nbytes)
        rec.held_bytes = 0
        rec.launches_per_replay.clear()
        if had_graphs or rec.captures:
            # return the freed pool's segments to the card
            torch.cuda.empty_cache()

    # -- capture ----------------------------------------------------------------
    def _static_inputs(self, v, flat, kept):
        """The graph's inputs, flattened like the arguments, into ``v``:
        the carry buffers at the donated positions, the caller's own
        tensor or module at the kept positions (by reference), a clone of
        every other tensor, a private generator per generator."""
        static = []
        for i, x in enumerate(flat):
            if i in v.donated:
                static.append(v.carry[v.donated.index(i)])
            elif i in kept:
                static.append(x)
                v.kept.append((i, _kept_storage(x)))
            elif isinstance(x, torch.Tensor):
                static.append(x.clone())
                self._static_bytes += _tensor_bytes([static[-1]])
            elif isinstance(x, torch.Generator):
                if x.device.type != "cuda":
                    raise ValueError(
                        f"program {self.name!r}: argument leaf {i} is a "
                        f"generator on {x.device}; a captured round draws "
                        "only from a CUDA generator")
                g = torch.Generator(device=x.device)
                v.gens.append((i, g))
                static.append(g)
            else:
                static.append(x)
        v.static = static
        return static

    def _capture(self, args, flat, spec, sig):
        from torch.utils._python_dispatch import _disable_current_modes

        device = self._device(flat)
        donated = _arg_positions(args, self.donate_argnums)
        kept = set(_arg_positions(args, self.keep_argnums))
        dsig = tuple(sig[1][i] for i in donated)
        carry = self._carry.get(dsig)
        if carry is None:
            # the first capture ADOPTS the donated tensors as the buffers
            carry = [flat[i] for i in donated]
            self._carry[dsig] = carry
        v = _Variant(f"variant {len(self._variants)}", donated, carry)
        static = self._static_inputs(v, flat, kept)
        static_args = tree_unflatten(static, spec)
        stream = _capture_stream(device)
        fn_name = getattr(self.fn, "__qualname__", self.name)
        # the call itself, eagerly on the side stream, on the graph's own
        # inputs: first-use work (library loads, cached device tables,
        # cuBLAS workspaces) happens here, never inside the capture
        for i, g in v.gens:
            g.set_state(flat[i].get_state())
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            carry_out, ys = self.fn(*static_args)
            _write_carry(fn_name, carry, carry_out)
        del carry_out
        for i, g in v.gens:
            flat[i].set_state(g.get_state())
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        # fresh containers for the capture: ``fn`` may consume the dicts
        # it is given (the optimizers' ``apply`` pops their leaves)
        static_args = tree_unflatten(static, spec)
        t0 = time.perf_counter()
        counts = launch_counts()
        graph = torch.cuda.CUDAGraph()
        for i, g in v.gens:
            g.set_state(flat[i].get_state())
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"program {self.name!r}: torch {torch.__version__} "
                    "cannot register a generator with a CUDA graph")
            graph.register_generator_state(g)
        last = _LastOp()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # while a capture is underway the allocator never returns cached
        # blocks to the card (not the default pool's, not those of dead
        # programs' pools), so an allocation the card could serve fails:
        # return them first
        torch.cuda.empty_cache()
        # the segments the pool gains during the capture: nothing else
        # allocates on the card meanwhile
        reserved = torch.cuda.memory_reserved(device)
        # no garbage collection while capturing: a collected program's
        # graph would be destroyed mid-capture, a call the capture refuses
        gc_on = gc.isenabled()
        gc.disable()
        # with a process group live, its watchdog thread queries CUDA
        # events while the capture is underway: a capture in "global" mode
        # would refuse those calls
        mode = ("thread_local" if torch.distributed.is_available()
                and torch.distributed.is_initialized() else "global")
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pool, capture_error_mode=mode)
                try:
                    # the capture is not a call: active dispatch modes (a
                    # collective recorder) see the first call and the
                    # replays, never the capture's dispatch
                    with _disable_current_modes(), last.mode:
                        graph_carry, graph_ys = self.fn(*static_args)
                        _write_carry(fn_name, carry, graph_carry)
                except Exception as e:
                    try:
                        graph.capture_end()
                    except Exception:
                        _abandon_capture(device, self._pool)
                    if not self._variants:
                        self._pool = None         # a retry takes a new pool
                    raise RuntimeError(
                        f"capture of program {self.name!r} ({fn_name}) "
                        f"failed at {last.last}: {type(e).__name__}: {e}"
                    ) from e
                graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
        torch.cuda.current_stream(device).wait_stream(stream)
        self._pool_bytes += max(0, torch.cuda.memory_reserved(device)
                                - reserved)
        after = launch_counts()
        v.launches = {n: after[n] - counts[n] for n in counts}
        _set_launch_counts(counts)
        v.collectives = last.collectives
        v.graph = graph
        v.ys, v.ys_spec = tree_flatten(graph_ys)
        rec = self.record
        rec.captured = True
        rec.why_uncaptured = None
        rec.captures += 1
        rec.capture_seconds += time.perf_counter() - t0
        rec.launches_per_replay[v.label] = dict(v.launches)
        if v.collectives:
            rec.collectives_per_replay[v.label] = tuple(
                str(f.overloadpacket) for f, _ in v.collectives)
        rec.held_bytes = (sum(_tensor_bytes(c) for c in self._carry.values())
                          + self._static_bytes + self._pool_bytes)
        if self.group is not None and rec.cache_key is not None:
            # the byte rule decides alike on every rank: one replaying
            # while another runs eagerly would issue other collectives
            rec.held_bytes = agree(self.group, [rec.held_bytes], "max")[0]
        return v, self._result(v, args, ys)

    # -- replay -----------------------------------------------------------------
    def _check_kept(self, v, flat):
        """Raise unless every kept leaf of ``flat`` is the object ``v``
        was captured with, its storage where the graph reads it."""
        for i, ptrs in v.kept:
            if flat[i] is not v.static[i] or _kept_storage(flat[i]) != ptrs:
                raise RuntimeError(
                    f"program {self.name!r}: kept argument leaf {i} "
                    f"({type(flat[i]).__name__}) is not the one its graph "
                    "was captured with, or its storage moved; a kept "
                    "argument is read in place and never copied into")

    def _replay(self, v, args, flat):
        rec = self.record
        self._check_kept(v, flat)
        moved = [i for i, (b, p) in enumerate(zip(v.carry, v.carry_ptrs))
                 if p is not None and b.data_ptr() != p]
        if moved:
            rec.in_place = False
            raise RuntimeError(
                f"program {self.name!r}: donated carry leaves {moved} moved "
                "away from the buffers its graph writes; a replay would "
                "write through their old addresses")
        handed = self._handed
        if handed is not None and all(
                r is None or flat[i] is r() for i, r in zip(v.donated, handed)):
            # the caller handed back the carry of the last replay: donation
            # holds when that carry IS the buffers (no copy into them)
            rec.in_place = rec.in_place is not False and all(
                flat[i] is b for i, b in zip(v.donated, v.carry))
        for x, s in zip(flat, v.static):
            if isinstance(x, torch.Tensor) and x is not s:
                s.copy_(x)          # kept leaves are ``s`` itself
        for i, g in v.gens:
            g.set_state(flat[i].get_state())
        v.graph.replay()
        if v.collectives:
            _hand_to_recorders(v.collectives)
        for i, g in v.gens:
            flat[i].set_state(g.get_state())
        ops = _ops()
        for n, k in v.launches.items():
            if k:
                getattr(ops, n).launches += k
        rec.replays += 1
        if rec.in_place is None:
            rec.in_place = True
        return self._result(v, args, tree_unflatten(v.ys, v.ys_spec))

    def _result(self, v, args, ys):
        """``(carry, ys)`` of a call, remembering the carry handed out
        (the next call's donation check)."""
        carry = self._hand_out(v, args)
        self._handed = [weakref.ref(x) if isinstance(x, torch.Tensor)
                        else None for x in tree_flatten(carry)[0]]
        return carry, ys

    def _hand_out(self, v, args):
        """The donated arguments after a replay: their buffers, updated in
        place by the graph."""
        args_out = tree_unflatten(v.static, tree_flatten(args)[1])
        return tuple(args_out[i] for i in self.donate_argnums)


def donating_graph(fn: Callable, donate_argnums=(), *,
                   name=None, count_traces: bool = True,
                   keep_argnums=(), group=None) -> Program:
    """A :class:`Program` running ``fn`` as one CUDA graph per argument
    signature (see the module docstring). ``fn(*args) -> (carry, ys)``,
    ``carry`` a tuple with one new value per ``donate_argnums`` entry, in
    order, shaped like that argument. ``keep_argnums``: arguments read in
    place, by reference. ``group``: the process group ``fn``'s collectives
    run on (a meshed round; see COLLECTIVES in the module docstring).
    Every program is registered for ``repro_torch.analysis``
    (:func:`registered_programs`). ``count_traces=False`` keeps its builds
    out of :data:`TRACE_COUNTS` (a program the JAX package's counterpart
    never traces through its program cache:
    ``ConsensusEngine.scan_rounds``)."""
    prog = Program(fn, donate_argnums, name, count_traces, keep_argnums,
                   group)
    _PROGRAM_REFS.append(weakref.ref(prog))
    for records in _COLLECTING:
        records.append(prog.record)
    return prog


# -- the program cache ------------------------------------------------------------

#: variants built per driver family ("fl_chunk", "maml_chunk"): captures
#: on the card, builds on the CPU — the observable the cache tests assert
#: on (one build across repeated driver calls)
TRACE_COUNTS: collections.Counter = collections.Counter()

#: program LRU capacity. Keys hold strong references to the functions and
#: engines they were built from, which both bounds memory and prevents
#: id()-reuse collisions while an entry is alive.
PROGRAM_CACHE_SIZE = 32
#: device bytes the cached programs may hold between driver calls (each
#: one's ``ProgramRecord.held_bytes``: carry buffers, static inputs, graph
#: pool); None lifts the cap. A program above the cap on its own falls
#: under the byte rule (module docstring): it stays cached and runs
#: eagerly (the carry of a K = 256 paper-DQN round alone is 0.83 GB in
#: f32, twice that with error feedback). Programs under the cap are
#: evicted least recently used first while together they exceed it. Set
#: it, then call :func:`trim_program_cache`, to change it for a process.
PROGRAM_CACHE_BYTES: Optional[int] = 1 << 30
_program_cache: "collections.OrderedDict" = collections.OrderedDict()

#: program-cache counters ("hits", "misses", "inserts", "evictions"),
#: read through :func:`cache_stats`
CACHE_STATS: collections.Counter = collections.Counter()


def _above_cap(nbytes: int) -> bool:
    return PROGRAM_CACHE_BYTES is not None and nbytes > PROGRAM_CACHE_BYTES


def cache_stats() -> dict:
    """Snapshot of the program cache: ``hits`` / ``misses`` (the drivers'
    :func:`get_cached_program` probes), ``inserts`` / ``evictions``
    (:func:`cached_program`, :func:`trim_program_cache`), ``size`` /
    ``capacity``, ``held_bytes`` / ``byte_capacity``,
    ``registered_programs``, ``trace_counts`` (a dict copy of
    :data:`TRACE_COUNTS`); and over every live program, cached or not,
    ``eager_by_byte_rule`` (how many run eagerly under the byte rule),
    ``scan_rounds_held_bytes`` (the bytes the engines' own
    ``scan_rounds`` programs hold, outside the cache) and
    ``per_call_held_bytes`` (the bytes the programs built per call, such
    as the launchers', hold while their call runs, outside the cache and
    the byte rule)."""
    live = registered_programs()
    return {
        "hits": CACHE_STATS["hits"],
        "misses": CACHE_STATS["misses"],
        "inserts": CACHE_STATS["inserts"],
        "evictions": CACHE_STATS["evictions"],
        "size": len(_program_cache),
        "capacity": PROGRAM_CACHE_SIZE,
        "held_bytes": sum(_held(p) for p in _program_cache.values()),
        "byte_capacity": PROGRAM_CACHE_BYTES,
        "registered_programs": len(live),
        "trace_counts": dict(TRACE_COUNTS),
        "eager_by_byte_rule": sum(r.why_uncaptured == OVER_BYTE_CAP
                                  for r in live),
        "scan_rounds_held_bytes": sum(
            r.held_bytes for r in live
            if r.cache_key is not None and r.cache_key[0] == "scan_rounds"),
        "per_call_held_bytes": sum(r.held_bytes for r in live
                                   if r.cache_key is None),
    }


def reset_cache_stats():
    """Zero the hit/miss/eviction counters and :data:`TRACE_COUNTS`.
    Does NOT drop cached programs — use :func:`clear_program_cache` for
    that."""
    CACHE_STATS.clear()
    TRACE_COUNTS.clear()


def _cache_lookup(key):
    """LRU-bumping lookup that leaves :data:`CACHE_STATS` alone."""
    try:
        fn = _program_cache.pop(key)
    except KeyError:
        return None
    _program_cache[key] = fn
    return fn


def get_cached_program(key):
    """Cached program for ``key`` (LRU-bumped), or None. Drivers check
    this BEFORE probing their round functions, so a hit skips the probes
    too; an entry exists only if its probes passed. Each call bumps
    ``hits`` or ``misses``."""
    fn = _cache_lookup(key)
    CACHE_STATS["hits" if fn is not None else "misses"] += 1
    return fn


def cached_program(key, build: Callable):
    """Memoize a round program (LRU, :data:`PROGRAM_CACHE_SIZE` entries
    and :data:`PROGRAM_CACHE_BYTES`). ``key`` is a hashable tuple covering
    everything the capture bakes in; ``build()`` makes the program on a
    miss. Admissions bump ``inserts`` and set the record's ``cache_key``;
    drops bump ``evictions``."""
    fn = _cache_lookup(key)
    if fn is None:
        fn = build()
        rec = getattr(fn, "record", None)
        if rec is not None:
            rec.cache_key = key
        CACHE_STATS["inserts"] += 1
    _program_cache[key] = fn
    trim_program_cache()
    return fn


def _held(program) -> int:
    rec = getattr(program, "record", None)
    return rec.held_bytes if rec is not None else 0


def trim_program_cache():
    """Apply the byte rule to every live program above
    :data:`PROGRAM_CACHE_BYTES` on its own (cached or not: it becomes
    eager and keeps its cache entry; a program built per call is
    exempt), then
    evict the least recently used until the cache fits
    :data:`PROGRAM_CACHE_SIZE` and the byte cap. Runs on every admission
    and after every capture. An evicted program lives on while a driver
    still runs it."""
    cap = PROGRAM_CACHE_BYTES
    if cap is not None:
        for p in _live_programs():
            if p.record.cache_key is not None \
                    and p.record.held_bytes > cap:
                p.make_eager(p.record.held_bytes)
    while len(_program_cache) > PROGRAM_CACHE_SIZE or (
            cap is not None and _program_cache
            and sum(_held(p) for p in _program_cache.values()) > cap):
        _program_cache.popitem(last=False)
        CACHE_STATS["evictions"] += 1


def clear_program_cache():
    """Drop every cached program (tests; frees engine refs and graphs)."""
    _program_cache.clear()


def evict_programs(records):
    """Drop the cached programs whose records are among ``records`` (a
    meshed run's programs, before its process group is destroyed)."""
    ids = {id(r) for r in records}
    for key in [k for k, p in _program_cache.items()
                if id(getattr(p, "record", None)) in ids]:
        del _program_cache[key]


# -- host side of a chunk -----------------------------------------------------------

def first_hit(reached_mask) -> Optional[int]:
    """Index of the first True in a per-round reached mask (host-side,
    one chunk), or None if the chunk never hit the target."""
    idx = np.flatnonzero(np.asarray(reached_mask))
    return int(idx[0]) if idx.size else None


def to_host(x: torch.Tensor) -> np.ndarray:
    """The drivers' one device→host read of a chunk (or, in streaming
    telemetry, of a round): waits for the device and copies ``x``."""
    return x.detach().cpu().numpy()


__all__ = [
    "ProgramRecord", "Program", "registered_programs",
    "clear_program_registry", "donating_graph", "own", "traceable",
    "uncaptured", "TRACE_COUNTS", "PROGRAM_CACHE_SIZE",
    "CACHE_STATS", "cache_stats", "reset_cache_stats", "tree_signature",
    "get_cached_program", "cached_program", "clear_program_cache",
    "PROGRAM_CACHE_BYTES", "trim_program_cache",
    "first_hit", "to_host", "launch_counts", "COUNTED_KERNELS",
    "OVER_BYTE_CAP", "held_bytes_lower_bound", "built_programs", "agree",
    "evict_programs",
]
