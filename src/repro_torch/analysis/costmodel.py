"""The cost-model layer (C1–C3): the port's counterpart of the JAX package's
``analysis/costmodel.py``, over the collectives a round really dispatches.

The paper's claims are a ledger: joules per round = bits on the wire x
per-class link efficiencies (Eq. 11), plus compute. Telemetry rows
reconcile ``==`` with the host replay; this layer checks that the
mechanism under them moves and computes what the ledger bills:

C1  (a) the bytes one process ships through its plan's priced collective
        in one round, as :class:`CollectiveRecorder` sees them cross the
        process group, lie in [expected, ``C1_RATIO`` x expected +
        ``C1_SLACK_BYTES``], expected being the codec's Eq.-(11) bits
        times the messages the plan sends (never fewer bytes than the
        ledger bills; never a dtype-wide regression); and
    (b) a host replay of the engine's blessed survival/availability
        streams reconciles EXACTLY (``==``) with a buffered-telemetry
        ``scan_rounds`` run: per-round per-class counts, ``n_active``,
        ``wire_bits`` and float64 Eq.-(11) joules, every plan x codec,
        async included.
C2  one dense-plan round's FLOPs, counted by
    ``torch.utils.flop_counter.FlopCounterMode``, within ``C2_RATIO`` of
    the counted 2·K²·N per leaf. A kernel launched through ``ctypes`` (B1,
    B2) runs below the dispatcher, where the counter cannot see it, so C2
    audits the dense plan only: the JAX package's audit does the same
    (its Pallas calls report no flops either).
C3  every c10d op a round dispatches is the plan's priced wire
    (``engine.audit_meta()['priced_collectives']``), one of a meshed
    engine's observer collectives (``audit_meta()['observer_collectives']``:
    the drivers' population gather for ``target_fn``, telemetry's
    disagreement all-reduces and ``train_federated``'s broadcast of the
    logged loss, matched by op AND bytes and booked only up
    to the calls the audited run makes, :func:`observer_calls`, on a
    ledger line of their own and never in the Eq.-(11) bill; a call past
    that count, or a count not reached, is a finding), control plane
    (integer or bool payload, or at most ``CONTROL_BYTES_PER_AGENT`` x K
    bytes), or a finding: unbilled payload movement.

The recorder is a ``TorchDispatchMode``: it sees each c10d op where
``torch.distributed`` hands it to the process group, so it reads what
crossed the group and not the engine's own bookkeeping, and it patches
nothing. The pure helpers (:func:`collective_ledger`,
:func:`check_round_flops`, :func:`check_wire_bytes`) take records and
numbers, so tests seed violations without a group; :func:`run_mesh_rounds`
spawns a gloo group on this host for C1a and C3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

#: dtypes that never carry wire payload: masks, schedule indices, counters,
#: keys. An int codec's lanes are int8 and floats are payload: neither is
#: here.
CONTROL_DTYPES = frozenset(
    {"bool", "int16", "int32", "int64", "uint16", "uint32", "uint64"})

#: a collective outside the priced wire whose payload is at most this many
#: bytes PER AGENT is control plane (availability bits, lane weights,
#: scale scalars), not an unbilled model wire
CONTROL_BYTES_PER_AGENT = 8

#: C1a's bracket: the priced collective may carry scale vectors over the
#: codec's bits, never a dtype-wide regression, and never fewer bytes
#: than the ledger bills
C1_RATIO = 1.35
C1_SLACK_BYTES = 128

#: C2's tolerance is coarse on purpose: a real drift (a wrong mixing
#: order, a dense rebuild) lands at K/2 x or more
C2_RATIO = 4.0
C2_SLACK_FLOPS = 1024.0

#: the receiving half of a p2p pair: the same bytes as the peer's send,
#: so C1a counts the shipping half only
WIRE_RECEIVES = frozenset({"recv_"})

DROPOUT_P = 0.3
#: processes of the C1a/C3 sweep: the JAX audit's forced 8 host devices
MESH_WORLD = 8


class Collective(NamedTuple):
    """One c10d op as the recorder saw it: ``kind`` (the op's name, e.g.
    ``_allgather_base_``, ``send``), the shapes and dtype names of the
    tensors it fills or ships (its first argument: the output of a
    gather, the sent or received buffers), and their bytes."""

    kind: str
    shape: str
    nbytes: int
    dtypes: frozenset


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def collective_of(func, args) -> Collective:
    """The :class:`Collective` record of one dispatched c10d op."""
    ts = _tensors(args[0]) if args else []
    return Collective(
        func._schema.name.split("::")[-1],
        "; ".join(f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
                  for t in ts),
        sum(t.numel() * t.element_size() for t in ts),
        frozenset(str(t.dtype).replace("torch.", "") for t in ts))


class CollectiveRecorder(TorchDispatchMode):
    """Within the block, every c10d op dispatched in this process is
    appended to ``records`` as a :class:`Collective`; every op still
    runs as it would. A captured round program
    (:func:`repro_torch.core.scanloop.donating_graph` on a meshed engine)
    dispatches its collectives on its first call, hides its capture's
    dispatch, and hands each replay's ops to :meth:`replayed`, so a
    captured run's records ``==`` the same run's under
    ``scanloop.uncaptured()``. The program layer's agreement all-reduces
    (``scanloop.agree``: int64 control words, once per program build) run
    outside every dispatch mode and are never recorded."""

    def __init__(self):
        super().__init__()
        self.records: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            self.records.append(collective_of(func, args))
        return func(*args, **(kwargs or {}))

    def replayed(self, collectives):
        """Record the c10d ops one replay of a captured program issued
        (``(op, args)`` pairs its capture recorded, the tensors as
        ``meta`` tensors of their shapes and dtypes)."""
        for func, args in collectives:
            self.records.append(collective_of(func, args))


@dataclasses.dataclass
class StaticLedger:
    """What one process moved in one audited round: bytes by priced op,
    control-plane bytes, and unpriced bytes (each a C3 finding)."""

    label: str
    plan: Optional[str] = None
    codec: Optional[str] = None
    priced_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: bytes and calls of the observer collectives, by quantity (never
    #: billed)
    observer_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    observer_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    control_bytes: int = 0
    unpriced_bytes: int = 0

    @property
    def wire_bytes(self) -> int:
        """Priced bytes this process shipped (a p2p pair's receives are
        its peers' sends)."""
        return sum(v for k, v in self.priced_bytes.items()
                   if k not in WIRE_RECEIVES)


# -- pure helpers ------------------------------------------------------------------


def observer_calls(evaluated: int, rows: int,
                   losses: int = 0) -> Dict[str, int]:
    """The observer calls a meshed driver run makes, by the quantities
    ``ConsensusEngine.audit_meta()`` names: one population gather per
    round ``target_fn`` evaluated, the disagreement's two all-reduces per
    telemetry row, and (``train_federated``, ``losses`` rounds) one
    broadcast of agent 0's logged loss a round. A bare round makes none
    (``{}``)."""
    calls = {"population for target_fn": evaluated,
             "disagreement column sums": rows,
             "disagreement distances": rows}
    if losses:
        calls["logged loss of agent 0"] = losses
    return calls


def collective_ledger(meta: dict, records, label: str,
                      observer_calls: Optional[Dict[str, int]] = None
                      ) -> Tuple[StaticLedger, List[Finding]]:
    """C3 over one round's (or one driver run's) records: classify each
    collective as priced (the plan's wire), an observer collective, control
    plane, or a finding. ``meta`` is ``engine.audit_meta()``, or ``{}``
    for a driver that prices no collective. ``observer_calls`` maps each
    quantity of ``meta["observer_collectives"]`` to the calls the audited
    run makes of it (:func:`observer_calls`; default none): a collective
    of an observer's op and bytes is booked while its quantity has calls
    left, one past them is a finding, and so is a quantity whose calls the
    records do not reach."""
    priced = meta.get("priced_collectives") or {}
    observers = list(meta.get("observer_collectives") or ())
    left = dict(observer_calls or {})
    k = meta.get("K") or 0
    ledger = StaticLedger(label=label, plan=meta.get("plan"),
                          codec=meta.get("codec"))
    findings: List[Finding] = []
    for kind, shape, nbytes, dtypes in records:
        named = [o["quantity"] for o in observers
                 if (o["op"], o["bytes"]) == (kind, nbytes)]
        quantity = next((q for q in named if left.get(q, 0) > 0), None)
        if kind in priced:
            ledger.priced_bytes[kind] = (
                ledger.priced_bytes.get(kind, 0) + nbytes)
        elif quantity is not None:
            left[quantity] -= 1
            ledger.observer_bytes[quantity] = (
                ledger.observer_bytes.get(quantity, 0) + nbytes)
            ledger.observer_calls[quantity] = (
                ledger.observer_calls.get(quantity, 0) + 1)
        elif named:
            ledger.unpriced_bytes += nbytes
            findings.append(Finding(
                "C3", label, 0,
                f"{kind} ships {nbytes} B of {shape}, the bytes of the "
                f"observer collective {named[0]!r}, past the "
                f"{(observer_calls or {}).get(named[0], 0)} call(s) the "
                "audited run makes of it: data movement outside the "
                "Eq.-(11) ledger"))
        elif dtypes <= CONTROL_DTYPES or nbytes <= CONTROL_BYTES_PER_AGENT * k:
            ledger.control_bytes += nbytes
        else:
            ledger.unpriced_bytes += nbytes
            findings.append(Finding(
                "C3", label, 0,
                f"{kind} ships {nbytes} B of {shape} outside the "
                f"Eq.-(11) ledger — the plan prices "
                f"{sorted(priced) or 'no collectives'}; map this "
                "transfer to a link class in audit_meta() or allowlist "
                "it with a note"))
    for quantity, n in left.items():
        if n:
            findings.append(Finding(
                "C3", label, 0,
                f"observer collective {quantity!r}: "
                f"{observer_calls[quantity]} call(s) expected, "
                f"{observer_calls[quantity] - n} recorded — the driver "
                "does not issue what audit_meta() describes"))
    return ledger, findings


def check_round_flops(measured: Optional[float], expected: float,
                      label: str) -> List[Finding]:
    """C2 core: a round's counted FLOPs must bracket the reference count
    within :data:`C2_RATIO`."""
    if measured is None:
        return [Finding(
            "C2", label, 0,
            "skipped: the flop counter reported nothing for this round — "
            "the compute half of the ledger cannot be checked here",
            allowlisted=True, note="environment, not code")]
    if (measured > expected * C2_RATIO + C2_SLACK_FLOPS
            or measured < expected / C2_RATIO):
        return [Finding(
            "C2", label, 0,
            f"the round costs {measured:.0f} flops but the counted "
            f"reference (2·K²·N per leaf) expects {expected:.0f} "
            f"({measured / max(expected, 1.0):.2f}x, tolerance "
            f"{C2_RATIO}x) — the compute model no longer describes the "
            "round")]
    return []


def check_wire_bytes(measured: int, expected: Optional[float], label: str,
                     priced) -> List[Finding]:
    """C1a core: the priced bytes one process shipped in one round must
    lie in [expected, C1_RATIO x expected + C1_SLACK_BYTES]."""
    if expected is None:
        return []
    ops = sorted(priced)
    if measured < expected:
        return [Finding(
            "C1", label, 0,
            f"the priced {ops} collective ships only {measured} "
            f"B/process/round but Eq.-(11) bills {expected:.0f} B — the "
            "ledger charges for bytes the round never moves")]
    if measured > expected * C1_RATIO + C1_SLACK_BYTES:
        return [Finding(
            "C1", label, 0,
            f"the priced {ops} collective ships {measured} B/process/round "
            f"but Eq.-(11) bills only {expected:.0f} B "
            f"({measured / expected:.2f}x, tolerance {C1_RATIO}x + "
            f"{C1_SLACK_BYTES} B) — the round moves more than the codec "
            "prices")]
    return []


def expected_wire_bytes(engine, per_agent: dict,
                        rank: int = 0) -> Optional[float]:
    """Priced bytes process ``rank`` ships through the plan's wire in one
    ``engine.step`` (the JAX package's ``_expected_wire_bytes``): one
    agent's codec bits x the messages the plan sends. The sharded plan's
    all-gather result holds all K agents' wire; the distributed plan sends
    one wire per schedule slot whose target is another process (a slot
    that pairs ``rank`` with itself is a local copy and ships nothing).
    None for a plan with no wire collective."""
    codec = engine.codec
    bits = (codec.model_bits(per_agent) if codec is not None
            else 32.0 * sum(x.numel() for x in per_agent.values()))
    if engine.plan.kind == "sharded":
        n_msgs = engine.K
    elif engine.plan.kind == "distributed":
        n_msgs = sum(1 for pairs, _sig in engine.schedule()
                     if next(t for s, t in pairs if s == rank) != rank)
    else:
        return None
    return n_msgs * bits / 8.0


# -- host replay (C1b) -------------------------------------------------------------


def static_round_counts(engine, rounds: int, *, t0: int = 0,
                        energy_params=None,
                        expected_bits: Optional[float] = None) -> List[dict]:
    """The static per-round ledger rows: replay the engine's blessed host
    streams (:func:`repro_torch.core.topology.dropout` for link fades,
    :func:`~repro_torch.core.topology.availability_stream` for agent
    churn: the draws the engine makes, bit for bit) and bill each round
    with the literal ``Topology.round_comm_joules``. A wire bills iff its
    link survived AND both endpoints were awake.

    ``expected_bits`` overrides the codec-priced per-message bits in
    ``wire_bits`` (the seeded-mispricing hook of the C1 tests); joules
    always come from the topology's own codec-aware pricing."""
    from repro_torch.core import energy, topology as topo_lib

    topo = engine.topology
    if topo is None:
        raise ValueError(
            f"static_round_counts needs an engine built from a Topology, "
            f"but this {engine.plan.kind!r} engine came from a raw mix "
            "matrix (no link classes to bill) — construct it from e.g. "
            "topology.ring(K)")
    ep = energy_params or energy.paper_calibrated("fig3")
    total = t0 + rounds
    graph = engine.graph
    if graph.kind == "dropout":
        adjs = [np.asarray(t_r.adjacency, bool) for t_r in
                topo_lib.dropout(topo, graph.p, seed=graph.seed,
                                 rounds=total)]
    elif graph.kind == "schedule":
        masks = np.asarray(graph.masks, bool)
        adjs = [np.asarray(topo.adjacency, bool) & masks[t % len(masks)]
                for t in range(total)]
    else:
        adjs = [np.asarray(topo.adjacency, bool)] * total
    if engine.agents is not None:
        acts = np.asarray(topo_lib.availability_stream(
            engine.agents, topo.K, total), bool)
    else:
        acts = np.ones((total, topo.K), bool)
    bits = float(ep.model_bits)
    if engine.codec is not None:
        bits = float(engine.codec.price_bits(bits))
    if expected_bits is not None:
        bits = float(expected_bits)
    link_class = np.asarray(topo.link_class)
    rows = []
    for t in range(t0, total):
        m = adjs[t] & acts[t][:, None] & acts[t][None, :]
        billed = topo_lib.Topology(
            f"{topo.name}~billed", m,
            np.where(m, link_class, topo_lib.NONE))
        counts = billed.links_per_round()
        n_sl, n_ul, n_dl = counts["SL"], counts["UL"], counts["DL"]
        rows.append({
            "round": t, "n_sl": n_sl, "n_ul": n_ul, "n_dl": n_dl,
            "n_active": int(acts[t].sum()),
            "wire_bits": bits * (n_sl + n_ul + n_dl),
            "joules": billed.round_comm_joules(ep, codec=engine.codec),
        })
    return rows


def reconcile_engine_run(engine, *, rounds: int, label: str,
                         energy_params=None,
                         expected_bits: Optional[float] = None,
                         params=None, device="cpu") -> List[Finding]:
    """C1b: drive ``rounds`` buffered-telemetry ``scan_rounds`` rounds
    and reconcile every measured row against :func:`static_round_counts`:
    counts and ``n_active`` as ints, ``wire_bits`` and joules as float64,
    ``==`` (both sides evaluate the same expression on the same draws).
    ``params``: agent-stacked params to run (default (K, 16) seeded
    normals on ``device``). On the card the rounds replay the engine's
    captured round program, so the rows reconciled are the graph's."""
    from repro_torch import telemetry as telemetry_lib
    from repro_torch.core import energy

    ep = energy_params or energy.paper_calibrated("fig3")
    static_rows = static_round_counts(engine, rounds, energy_params=ep,
                                      expected_bits=expected_bits)
    if params is None:
        g = torch.Generator(device="cpu").manual_seed(7)
        params = {"w": torch.randn((engine.K, 16), generator=g).to(device)}
    dev = next(iter(params.values())).device
    tel = telemetry_lib.Telemetry(energy_params=ep)
    engine.scan_rounds(params, rounds=rounds, telemetry=tel,
                       generator=torch.Generator(device=dev).manual_seed(11))
    events = tel.events(driver="consensus")
    if len(events) != rounds:
        return [Finding(
            "C1", label, 0,
            f"telemetry produced {len(events)} round events for a "
            f"{rounds}-round run — the measured ledger is incomplete, "
            "nothing to reconcile")]
    findings: List[Finding] = []
    for s, e in zip(static_rows, events):
        t = s["round"]
        for f in ("n_sl", "n_ul", "n_dl", "n_active"):
            if e[f] != s[f]:
                findings.append(Finding(
                    "C1", label, t,
                    f"round {t}: static replay predicts {f}={s[f]} but "
                    f"the measured row says {e[f]} — the round moved "
                    "wires the host streams did not predict (or vice "
                    "versa)"))
        if e["wire_bits"] != s["wire_bits"]:
            findings.append(Finding(
                "C1", label, t,
                f"round {t}: static ledger prices {s['wire_bits']:.0f} "
                f"wire bits but the measured row bills "
                f"{e['wire_bits']:.0f} — the per-message bits disagree "
                "with codec.price_bits(model_bits)"))
        if e["joules"] != s["joules"]:
            findings.append(Finding(
                "C1", label, t,
                f"round {t}: static Eq.-(11) replay bills "
                f"{s['joules']!r} J but the row recorded {e['joules']!r} "
                "J — the float64 pricing expressions diverged"))
    return findings


# -- live audits (the CLI's cost layer) --------------------------------------------


def audit_round_flops(k: int = 12, widths=(64, 8),
                      device="cpu") -> List[Finding]:
    """C2 on the case-study shape (12 robots, leaves of widths 64 and 8;
    the smoke adds K = 256 at paper-DQN width on the card): one
    uncompressed dense-plan round under ``FlopCounterMode`` against
    2·K²·N per leaf."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine

    eng = ConsensusEngine(topo_lib.ring(k), plan="dense")
    params = {f"w{i}": torch.zeros((k, n), device=device)
              for i, n in enumerate(widths)}
    counter = FlopCounterMode(display=False)
    with counter:
        eng.step(params)
    expected = float(sum(2 * k * k * n for n in widths))
    return check_round_flops(float(counter.get_total_flops()), expected,
                             f"engine:dense/K={k} (case study)")


#: (plan, codec) pairs of the mesh sweep: the JAX package's matrix
MESH_CASES = tuple((plan, codec) for plan in ("sharded", "distributed")
                   for codec in (None, "int8"))


#: rounds of each rank's meshed driver run (:func:`_mesh_rows`)
MESH_DRIVER_ROUNDS = 2


def _mesh_rows(rank: int, world: int, n: int) -> List[dict]:
    """One rank's masked round and meshed driver run of each pair of
    :data:`MESH_CASES` on the initialised group (K = ``world``: one agent
    per position), each recorded with the observer calls it must make
    (row key ``driver``: None for the round, which makes none). The
    driver run is ``multichip.fl_run``: ``run_fl_until_scan`` at chunk 2
    for :data:`MESH_DRIVER_ROUNDS` rounds, buffered telemetry, a
    generator, a target never reached (every round evaluated)."""
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.launch import mesh as mesh_lib, multichip

    mesh = mesh_lib.make_agent_mesh(device_type="cpu")
    topo = topo_lib.ring(world)
    g = torch.Generator(device="cpu").manual_seed(0)
    pop = {"w": torch.randn((world, n), generator=g)}
    rows = []
    for plan, codec in MESH_CASES:
        eng = ConsensusEngine(
            topo, codec=codec, plan=plan, mesh=mesh,
            num_blocks=world if plan == "sharded" else None,
            graph=topo_lib.GraphProcess.dropout(DROPOUT_P, seed=0))
        mine = {k: v[eng.local_rows].contiguous() for k, v in pop.items()}
        agent = {k: v[0] for k, v in mine.items()}
        per_round = expected_wire_bytes(eng, agent, rank)
        state = eng.init_state(mine)
        with CollectiveRecorder() as rec:
            eng.step(mine, state, t=0)
        rows.append(dict(
            rank=rank, plan=plan, codec=codec, driver=None,
            meta=eng.audit_meta(agent), records=list(rec.records),
            observer_calls={}, expected=per_round))
        run = multichip.fl_run(eng, mine, -1.0, chunk=MESH_DRIVER_ROUNDS,
                               device="cpu", max_rounds=MESH_DRIVER_ROUNDS,
                               record=True)
        rows.append(dict(
            rank=rank, plan=plan, codec=codec, driver="run_fl_until_scan",
            meta=run["meta"], records=run["records"],
            observer_calls=run["observer_calls"],
            expected=MESH_DRIVER_ROUNDS * per_round))
    return rows


def run_mesh_rounds(world: int = MESH_WORLD, n: int = 64, *,
                    timeout_s: float = 120.0) -> List[dict]:
    """Spawn a gloo group of ``world`` processes on this host
    (:func:`repro_torch.launch.mesh.run_on_group`: a file store, no
    network) and record one masked round and the meshed
    ``run_fl_until_scan`` (:func:`_mesh_rows`) of each pair of
    :data:`MESH_CASES` in every rank. Returns every rank's rows (meta,
    records, observer calls, expected bytes); raises if a rank failed or
    hung."""
    from repro_torch.launch import mesh as mesh_lib

    got = mesh_lib.run_on_group(world, _mesh_rows, n, timeout_s=timeout_s)
    return [row for rows in got for row in rows]


def audit_mesh_ledgers(rows) -> List[Finding]:
    """C1a + C3 on a real process group: each rank's recorded round or
    driver run of each plan x codec (``rows``, from
    :func:`run_mesh_rounds`), its :func:`collective_ledger` with the
    observer calls the row must make (none when the row names none), and
    its shipped priced bytes against :func:`expected_wire_bytes` (times
    the rounds a driver ran)."""
    findings: List[Finding] = []
    for row in rows:
        label = (f"{'engine' if row.get('driver') is None else 'driver'}:"
                 f"{row['plan']}/{row['codec'] or 'f32'}/p={DROPOUT_P}"
                 + (f"/{row['driver']}" if row.get("driver") else ""))
        ledger, c3 = collective_ledger(row["meta"], row["records"], label,
                                       row.get("observer_calls"))
        findings += c3
        findings += check_wire_bytes(
            ledger.wire_bytes, row["expected"], label,
            row["meta"]["priced_collectives"])
    return findings


def _tiny_drivers(device="cpu") -> List[Tuple[str, list]]:
    """The chunked drivers tiny, in one process (engines without a mesh),
    each under the recorder: (name, records) of ``engine.scan_rounds``
    (async, telemetry), ``run_fl_until_scan`` (int8, chunk 2) and
    ``maml_train_scan``. They run under ``scanloop.uncaptured()``: the
    recorder reads the ops each round dispatches, and a replayed CUDA
    graph dispatches none, so on the card captured rounds would show it
    the first round's capture only. The meshed drivers run on the spawned
    group (:func:`run_mesh_rounds`)."""
    from repro_torch import telemetry as telemetry_lib
    from repro_torch.core import federated, maml, scanloop
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine

    K, D = 4, 8
    g = torch.Generator(device="cpu").manual_seed(0)
    xs = torch.randn((2, K, 4, D), generator=g).to(device)

    def loss_fn(p, batch):
        return torch.mean((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2)

    def sample_batches(_gen, t):
        x = xs[t % 2]
        return {"x": x, "y": x.sum(-1, keepdim=True)}

    def target_fn(stacked):
        d = torch.mean(stacked["w"])
        return d < -1e9, d

    def sample_tasks(_gen, t):
        x = xs[t % 2, :2]
        b = {"x": x, "y": x.sum(-1, keepdim=True)}
        return b, b

    stacked = {"w": torch.zeros((K, D, 1), device=device),
               "b": torch.zeros((K, 1), device=device)}
    out = []
    eng = ConsensusEngine(
        topo_lib.ring(K), codec="int8",
        graph=topo_lib.GraphProcess.dropout(DROPOUT_P, seed=0),
        agents=topo_lib.AgentProcess.bernoulli(0.6, seed=1), tau=2,
        staleness_decay=0.9)
    gen = torch.Generator(device=device).manual_seed(0)
    with scanloop.uncaptured():
        with CollectiveRecorder() as rec:
            eng.scan_rounds({"w": stacked["w"][:, :, 0]}, generator=gen,
                            rounds=2, telemetry=telemetry_lib.Telemetry())
        out.append(("driver:scan_rounds", rec.records))
        with CollectiveRecorder() as rec:
            federated.run_fl_until_scan(
                loss_fn, stacked, sample_batches,
                ConsensusEngine(topo_lib.ring(K), codec="int8"), 0.1,
                target_fn=target_fn, max_rounds=2, generator=gen, chunk=2)
        out.append(("driver:run_fl_until_scan", rec.records))
        with CollectiveRecorder() as rec:
            maml.maml_train_scan(
                loss_fn, {"w": stacked["w"][0], "b": stacked["b"][0]},
                sample_tasks, rounds=2, inner_lr=0.1, outer_lr=0.1, chunk=2)
        out.append(("driver:maml_train_scan", rec.records))
    return out


def audit_registered_collectives(drivers) -> List[Finding]:
    """C3 over the chunked drivers: the port has no program cache to
    recompile, so it runs each driver tiny in this process under the
    recorder (``drivers``: :func:`_tiny_drivers`' records) and demands
    no payload collective — without a mesh the drivers run in one
    process; any payload collective here is data movement no ledger
    bills. (On a mesh they add the observer collectives, which
    :func:`audit_mesh_ledgers` books.)"""
    findings: List[Finding] = []
    for name, records in drivers:
        findings += collective_ledger({}, records, name)[1]
    return findings


def audit_ledger_reconciliation(rounds: int = 3, k: int = 8,
                                device="cpu") -> List[Finding]:
    """C1b matrix: every plan x {uncoded, int8:b64}, dropout active, plus
    one async config (bernoulli churn + staleness bound) per plan."""
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine

    topo = topo_lib.ring(k)
    findings: List[Finding] = []
    for plan, kw in (("dense", {}), ("sparse", {}),
                     ("sharded", {"num_blocks": 4}), ("distributed", {})):
        for codec in (None, "int8:b64"):
            eng = ConsensusEngine(
                topo, codec=codec, plan=plan,
                graph=topo_lib.GraphProcess.dropout(DROPOUT_P, seed=0), **kw)
            findings += reconcile_engine_run(
                eng, rounds=rounds, device=device,
                label=f"engine:{plan}/{codec or 'f32'}/p={DROPOUT_P}")
        eng = ConsensusEngine(
            topo, codec="int8:b64", plan=plan,
            graph=topo_lib.GraphProcess.dropout(DROPOUT_P, seed=0),
            agents=topo_lib.AgentProcess.bernoulli(0.6, seed=1),
            tau=2, staleness_decay=0.9, **kw)
        findings += reconcile_engine_run(
            eng, rounds=rounds, device=device,
            label=f"engine:{plan}/int8:b64/p={DROPOUT_P}/async")
    return findings


def audit_paper_width(k: int = 256, rounds: int = 3,
                      device="cuda") -> List[Finding]:
    """C2 and C1b at the case study's full width: paper-DQN leaves
    stacked over ``k`` agents. C2 on one dense round; C1b on the dense and
    sparse plans (the sparse plan launches B2 on the f32 wire and B1 on
    the int8 wire when ``device`` is the card), links fading."""
    from repro_torch.configs import get_arch
    from repro_torch.core import topology as topo_lib
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.models import dqn

    one = dqn.init(get_arch("paper-dqn"), device="cpu")
    g = torch.Generator(device="cpu").manual_seed(0)
    pop = {name: torch.randn((k,) + tuple(t.shape), generator=g).to(device)
           for name, t in one.items()}
    findings = audit_round_flops(k, [t.numel() for t in one.values()],
                                 device=device)
    for plan in ("dense", "sparse"):
        for codec in (None, "int8"):
            eng = ConsensusEngine(
                topo_lib.ring(k), codec=codec, plan=plan,
                graph=topo_lib.GraphProcess.dropout(DROPOUT_P, seed=0))
            findings += reconcile_engine_run(
                eng, rounds=rounds, params=pop,
                label=f"engine:{plan}/{codec or 'f32'}/p={DROPOUT_P}/"
                      f"K={k} paper-dqn")
    return findings


def run_cost_audit(device="cpu") -> List[Finding]:
    """The full C-layer pass: C2, C1a + C3 on a spawned gloo group of
    :data:`MESH_WORLD` ranks (a round and the meshed FL driver of each
    plan x codec), C3 over the one-process drivers and the C1b matrix, the
    engine's rounds on ``device``; on the card also
    :func:`audit_paper_width`."""
    findings = audit_round_flops(device=device)
    findings += audit_mesh_ledgers(run_mesh_rounds())
    findings += audit_registered_collectives(_tiny_drivers(device))
    findings += audit_ledger_reconciliation(device=device)
    if torch.device(device).type == "cuda":
        findings += audit_paper_width(device=device)
    return findings
