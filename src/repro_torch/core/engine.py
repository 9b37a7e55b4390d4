"""ConsensusEngine — the single entry point for one Eq.-(6) mixing round.

A ``(Topology, K, codec, GraphProcess, AgentProcess)`` description
resolves ONCE, at construction, into an execution plan, and every caller
drives the same ``engine.step(stacked_params, codec_state, generator) ->
(params, codec_state)``.

Plans
-----
* ``dense``  — the reference (K, K) matmul per leaf.
* ``sparse`` — one launch per leaf of the population-level consensus
  kernels (:mod:`repro_torch.kernels.ops`): each agent gathers its H
  neighbour rows from the (K, N) stack, O(K·H·N) instead of O(K²·N).
  Int wires stay int8 lanes into the fused dequantizing kernel.
* ``sharded`` — the population in ``num_blocks`` blocks of agents: each
  block encodes its own rows, the (K, ·) codec wire is gathered, and each
  block mixes its rows from it (one B1/B2 launch per block per leaf;
  :func:`repro_torch.core.consensus.sharded_consensus_step`).
* ``distributed`` — one agent per position: wires travel in the slots of
  :func:`repro_torch.core.consensus.permutation_schedule`
  (:func:`repro_torch.core.consensus.distributed_consensus_step`).

The JAX package's plan names ``dense-xla`` and ``sparse-pallas`` are
accepted as aliases. ``plan="auto"`` without a mesh uses the
payload-aware density heuristic
:func:`repro_torch.core.consensus.auto_path`; with a ``mesh`` (a
``torch.distributed.device_mesh.DeviceMesh``, see
:mod:`repro_torch.launch.mesh`) whose ``axis_name`` dimension carries
agents, one agent per position gives ``distributed`` and anything else
``sharded``. On a mesh each process passes ITS rows (its block, or its one
agent) to :meth:`ConsensusEngine.step`; without one the sharded and
distributed plans run the whole population in this process, through the
same per-block and per-slot functions.

Time-varying graphs (``graph=GraphProcess.dropout(p, seed)`` or
``.schedule(masks)``): each round's edge survival is drawn per edge by
:func:`repro_torch.core.topology.survival_mask` in the plan's own shape,
a (K, K) mask on the dense plan, (K, H) neighbour lanes on the sparse
plan (no (K, K) buffer), and σ is renormalised on the survivors: the
dense plan rebuilds the (K, K) mix, the sparse plan renormalises its
lanes, where faded and padding lanes carry σ = 0, exact no-ops in the
kernels.

Asynchronous consensus (``agents=AgentProcess...``, ``tau=``,
``staleness_decay=``): each round draws who is awake
(:func:`repro_torch.core.topology.availability_mask`). Sleeping agents
freeze (params, codec residuals, round clocks hold bit for bit); their
neighbours mix the frozen last-published state at weight λ^age until the
wire's age passes τ, through the same σ renormalisation, which takes
float lane weights. :class:`AsyncState` carries clocks and ages between
rounds. ``AgentProcess.always_on()`` with τ = ∞ reduces to the lockstep
engine bit for bit (weights are exactly {0.0, 1.0}).

:meth:`ConsensusEngine.scan_rounds` runs R rounds as R replays of ONE
round program (:meth:`ConsensusEngine.round_program`, a
:func:`repro_torch.core.scanloop.donating_graph`: on the card a CUDA
graph of :meth:`step` / :meth:`async_step` and the telemetry row, the
carry updated in place), drawing all R rounds' survival and availability
in one vectorised call on the params' device first. The engine holds its
programs itself, one per argument signature, outside the drivers'
program cache; they die with the engine.

Every compressed plan recentres each agent on its OWN decoded copy
(CHOCO), so under doubly-stochastic σ the population mean is exact
whatever the codec.

``scan_rounds(telemetry=)`` records one row per round
(:mod:`repro_torch.telemetry`) from the same survival or delivered tensor
the round mixed with. On a mesh each process draws every round's
survival and availability for all K agents, so every count of a row is
the one-process count on every rank with no communication; only the
disagreement needs the population, which two observer all-reduces give
(:func:`repro_torch.telemetry.buffer.mesh_disagreement`).
"""
from __future__ import annotations

import difflib
import weakref
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import consensus, scanloop
from repro_torch.core import topology as topo_lib

PLAN_KINDS = ("dense", "sparse", "sharded", "distributed")
PLAN_ALIASES = {"dense-xla": "dense", "sparse-pallas": "sparse"}
#: plans that accept a per-round survival operand: all four (the
#: distributed plan masks the slots of its fixed schedule superset)
MASKABLE_PLANS = PLAN_KINDS
#: plans whose survival and σ live on the (K, H) neighbour lanes
LANE_PLANS = ("sparse", "sharded")

#: per-plan facts :mod:`repro_torch.analysis.costmodel` keys on (the JAX
#: package's ``PLAN_AUDIT_EXPECTATIONS`` under the port's plan names).
#: ``kk_buffer``: whether the plan may legitimately hold a (K, K) tensor
#: (the dense σ stack). ``wire_collective``: the c10d op(s) that carry the
#: codec WIRE between processes on a mesh: the all-gather of the sharded
#: plan (``all_gather_into_tensor`` dispatches ``c10d._allgather_base_``),
#: the p2p pair of the distributed plan's ``batch_isend_irecv`` slots
#: (``c10d.send`` / ``c10d.recv_``). ``int_lane_gather``: the plan mixes
#: int-codec wires through a fused gather that keeps int8 lanes.
PLAN_AUDIT_EXPECTATIONS = {
    "dense":       {"kk_buffer": True, "wire_collective": None,
                    "int_lane_gather": False},
    "sparse":      {"kk_buffer": False, "wire_collective": None,
                    "int_lane_gather": True},
    "sharded":     {"kk_buffer": False,
                    "wire_collective": ("_allgather_base_",),
                    "int_lane_gather": True},
    "distributed": {"kk_buffer": False, "wire_collective": ("send", "recv_"),
                    "int_lane_gather": False},
}

#: largest permutation-schedule superset a time-varying or async
#: ``distributed`` engine accepts (≈ the base graph's max degree, one slot
#: per matching). Every masked round ships all M slots whether or not
#: their edges survived, so a graph needing more slots is refused at
#: construction (the sharded plan masks per lane and has no schedule).
DISTRIBUTED_SCHEDULE_BOUND = 64


@dataclass(frozen=True)
class ExecutionPlan:
    """A resolved consensus execution strategy (see module docstring)."""

    kind: str
    reason: str
    num_blocks: int = 1
    axis_name: str = "agents"

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            names = PLAN_KINDS + tuple(PLAN_ALIASES) + ("auto",)
            close = difflib.get_close_matches(str(self.kind), names, n=1)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            raise ValueError(f"unknown plan {self.kind!r}; choose from "
                             f"{names}{hint}")


class AsyncState(NamedTuple):
    """Carry of an async engine: ``clock`` (K,) int32 rounds each agent
    has participated in; ``age`` plan-shaped int32 rounds since each lane
    last delivered a fresh wire ((K, K) dense, (K, H) sparse and sharded,
    (M, K) schedule slots distributed)."""

    clock: torch.Tensor
    age: torch.Tensor


class AsyncRound(NamedTuple):
    """One round's availability facts (:meth:`ConsensusEngine.
    async_round`): ``act`` (K,) activity; ``weights`` plan-shaped float32
    σ input (1 fresh, λ^age stale, 0 dropped); ``delivered`` plan-shaped
    bools of the wires actually shipped (what Eq. (11) bills); ``age``
    the post-round wire ages."""

    act: torch.Tensor
    weights: torch.Tensor
    delivered: torch.Tensor
    age: torch.Tensor


def where_active(active, new, old):
    """Per-agent select over dicts of K-stacked tensors: row ``k`` takes
    ``new[k]`` where ``active[k]`` else ``old[k]``; a 0-d ``active``
    selects for every agent at once. An all-True (all-False) mask returns
    the first (second) operand's values exactly."""
    act = torch.as_tensor(active, dtype=torch.bool)
    out = {}
    for name, n in new.items():
        a = act.reshape(act.shape + (1,) * (n.ndim - 1))
        out[name] = torch.where(a, n, old[name])
    return out


def _device(t, device) -> torch.device:
    """Where a draw for round(s) ``t`` runs: ``t``'s device when it is a
    tensor, else ``device`` (default the card)."""
    if isinstance(t, torch.Tensor):
        return t.device
    return torch.device(device if device is not None else "cuda")


class ConsensusEngine:
    """One Eq.-(6) round behind one entry point (see module docstring).

    topology:   a :class:`repro_torch.core.topology.Topology` (also
                enables :meth:`round_comm_joules`) or a concrete (K, K) σ.
    codec:      exchange codec spec/Codec; lossy codecs get error
                feedback unless ``error_feedback=False``.
    mesh:       a ``torch.distributed.device_mesh.DeviceMesh`` whose
                ``axis_name`` dimension carries agents (one per position ⇒
                distributed; blocks ⇒ sharded), or None (one process).
    plan:       "auto", one of :data:`PLAN_KINDS`, or a JAX plan alias.
    num_blocks: block count of the sharded plan (default: the mesh axis
                size, else 1).
    data_sizes / mix_kind / include_self: forwarded to ``mixing`` and
                reused to renormalise σ on each round's surviving lanes.
    gamma:      CHOCO consensus step size (damps off-diagonal σ).
    graph:      a :class:`~repro_torch.core.topology.GraphProcess` (None
                ⇒ static).
    agents:     a :class:`~repro_torch.core.topology.AgentProcess` (None
                ⇒ lockstep); attaching one makes the engine async.
    tau:        hard staleness bound in rounds (async only; None ⇒ ∞).
    staleness_decay: λ ∈ (0, 1]; stale lanes mix at λ^age.
    """

    def __init__(self, topology, *, codec=None, mesh=None,
                 plan: str = "auto", axis_name: str = "agents",
                 num_blocks: Optional[int] = None, data_sizes=None,
                 mix_kind: str = "paper", include_self: bool = True,
                 gamma: float = 1.0, error_feedback: bool = True,
                 graph=None, agents=None, tau=None,
                 staleness_decay: float = 1.0):
        from repro_torch.comms import codecs
        if isinstance(topology, ConsensusEngine):
            raise TypeError(
                f"topology= got an already-built ConsensusEngine "
                f"(plan={topology.plan.kind!r}); pass a Topology or mix "
                "matrix, or coerce with ConsensusEngine.wrap(engine)")
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    f"mesh={mesh!r} is not a torch.distributed.device_mesh."
                    "DeviceMesh: build one with repro_torch.launch.mesh."
                    "make_agent_mesh() over an initialised process group, "
                    "or drop mesh= to run the population in one process")
        self.mesh = mesh
        if mix_kind not in consensus.MIX_KINDS:
            raise ValueError(consensus._unknown_kind_msg(mix_kind))
        self.topology = topology if hasattr(topology, "mixing") else None
        self.mix = np.asarray(
            topology.mixing(data_sizes, kind=mix_kind,
                            include_self=include_self)
            if self.topology is not None else topology, np.float32)
        if self.mix.ndim != 2 or self.mix.shape[0] != self.mix.shape[1]:
            raise ValueError(f"mix must be (K, K), got {self.mix.shape}")
        self.K = self.mix.shape[0]
        self.codec = codecs.resolve_codec(codec, error_feedback)
        self.gamma = float(gamma)
        self.mix_kind = mix_kind
        self.include_self = include_self
        self.data_sizes = (None if data_sizes is None
                           else np.asarray(data_sizes, np.float32))
        self.graph = (graph if graph is not None
                      else topo_lib.GraphProcess.static())
        if agents is not None and not isinstance(agents,
                                                 topo_lib.AgentProcess):
            raise TypeError(
                f"agents= takes a repro_torch.core.topology.AgentProcess "
                f"(or None), got {agents!r}; build one with "
                "AgentProcess.always_on() / .bernoulli(p_active) / "
                ".straggler(K) / .arrival(t_join) / .departure(t_leave)")
        self.agents = agents
        if agents is not None:
            if self.topology is None:
                raise ValueError(
                    f"agents={agents!r} needs an engine built from a "
                    "Topology, but this one came from a raw mix matrix: "
                    "staleness σ is REBUILT per round from the "
                    "delivered/stale lanes with the engine's mixing "
                    "kind, which cannot faithfully renormalize an "
                    "arbitrary raw mix — construct from a Topology "
                    "(e.g. topology.ring(K)) or drop agents=")
            pk = agents.K
            if pk is not None and pk != self.K:
                raise ValueError(
                    f"agents={agents!r} pins a population of {pk} "
                    f"agents but this engine's topology has K="
                    f"{self.K}; rebuild the process at K={self.K}")
        if tau is not None and agents is None:
            raise ValueError(
                f"tau={tau!r} (the hard staleness bound) only applies "
                "to async engines: pass agents=AgentProcess.… alongside "
                "it, or drop tau= for the lockstep protocol")
        if tau is not None:
            tf = float(tau)
            if np.isnan(tf) or tf < 0:
                raise ValueError(
                    f"tau={tau!r} is not a staleness bound: τ counts "
                    "rounds since the last delivered wire — use "
                    "tau=None (∞: stale lanes never drop), tau=0 "
                    "(only fresh wires mix), or a positive round count")
            tau = None if np.isinf(tf) else tf
        self.tau = tau
        self.staleness_decay = float(staleness_decay)
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError(
                f"staleness_decay={staleness_decay!r} must lie in "
                "(0, 1]: a stale lane mixes at weight λ^age — use "
                "λ=1.0 (no decay, the lockstep-exact default) or a "
                "positive fraction like 0.9")
        self.plan = self._resolve_plan(plan, axis_name, num_blocks)
        self._structure_np = None
        self._masked_struct = None     # (idx, lane-valid) of the base graph
        self._schedule = None          # distributed permutation slots
        self._sched_struct = None      # (srcs, real) of the schedule
        self._sched_keep = None        # schedule masks gathered to lanes
        self._on_device = {}           # (name, device) -> tensor
        #: scan_rounds' round programs, by argument signature
        self._round_programs = {}
        self.local_rows = self._local_rows()
        if self.graph.kind != "static":
            if self.topology is None:
                raise ValueError(
                    f"graph={self.graph!r} (time-varying) needs an "
                    "engine built from a Topology, but this one came "
                    "from a raw mix matrix: each round's σ is REBUILT "
                    "from the surviving graph with the engine's mixing "
                    "kind/data_sizes, which cannot faithfully "
                    "renormalize an arbitrary raw mix — construct from "
                    "a Topology or use GraphProcess.static()")
            self._adjacency = np.asarray(self.topology.adjacency, bool)
            self._symmetric = self.topology.is_symmetric
            if (self.graph.kind == "schedule"
                    and self.graph.masks.shape[1:] != (self.K, self.K)):
                raise ValueError(
                    f"schedule masks are {self.graph.masks.shape[1:]}, "
                    f"population is K={self.K}")
        if (self.plan.kind == "distributed"
                and (self.graph.kind != "static" or self.agents is not None)):
            # every surviving (or delivered) graph is a subgraph of the
            # base graph, so the base graph's schedule covers every round:
            # masked slots ride with σ = 0
            M = len(self.schedule())
            if M > DISTRIBUTED_SCHEDULE_BOUND:
                raise ValueError(
                    f"time-varying/async engines on the distributed plan "
                    f"mask a fixed permutation-schedule superset, and this "
                    f"graph needs {M} schedule slots (≈ max degree "
                    f"{self.topology.max_degree}) — over the "
                    f"{DISTRIBUTED_SCHEDULE_BOUND}-slot bound "
                    "(DISTRIBUTED_SCHEDULE_BOUND). Use a sparser base "
                    "graph, or the sharded plan (per-lane masks, no "
                    "schedule)")

    # -- plan selection ---------------------------------------------------------
    def _resolve_plan(self, plan: str, axis_name: str,
                      num_blocks: Optional[int]) -> ExecutionPlan:
        mesh_axis = consensus.mesh_axis_size(self.mesh, axis_name)
        if plan == "auto":
            if mesh_axis is not None:
                if mesh_axis == self.K:
                    return ExecutionPlan(
                        "distributed", "mesh holds one agent per "
                        f"'{axis_name}' position", 1, axis_name)
                nb = num_blocks or mesh_axis
                if self.K % nb:
                    # honour the mesh: the largest block count that
                    # divides K, never a single-program fallback
                    nb = next(d for d in range(min(nb, self.K), 0, -1)
                              if self.K % d == 0)
                return ExecutionPlan(
                    "sharded", f"K={self.K} agents in {nb} blocks over "
                    f"the {mesh_axis}-wide '{axis_name}' mesh axis",
                    nb, axis_name)
            base = getattr(self.codec, "inner", self.codec)
            kind = consensus.auto_path(self.mix, codec=base)
            return ExecutionPlan(
                kind, f"payload-aware density heuristic (max degree vs "
                f"K={self.K})", 1, axis_name)
        kind = PLAN_ALIASES.get(plan, plan)
        if kind == "sharded":
            return ExecutionPlan("sharded", "explicit",
                                 num_blocks or mesh_axis or 1, axis_name)
        return ExecutionPlan(kind, "explicit", num_blocks or 1, axis_name)

    def _local_rows(self) -> Optional[slice]:
        """The population rows this process holds when the plan runs on
        the mesh (its block, or its one agent); None when it holds all K
        (no mesh, or a plan that does not run on it)."""
        size = consensus.mesh_axis_size(self.mesh, self.plan.axis_name)
        kind = self.plan.kind
        if kind == "sharded" and size == self.plan.num_blocks:
            B = self.K // self.plan.num_blocks
            r = self.mesh.get_local_rank(self.plan.axis_name)
            return slice(r * B, (r + 1) * B)
        if kind == "distributed" and size == self.K:
            r = self.mesh.get_local_rank(self.plan.axis_name)
            return slice(r, r + 1)
        return None

    @property
    def group(self):
        """The process group of the agent axis the plan runs on (the
        collectives of a meshed round), None when this process holds all
        K (``local_rows`` None)."""
        if self.local_rows is None:
            return None
        return self.mesh.get_group(self.plan.axis_name)

    @property
    def mesh_positions(self) -> int:
        """Positions the plan spreads over (1 in one process)."""
        if self.local_rows is None:
            return 1
        return (self.plan.num_blocks if self.plan.kind == "sharded"
                else self.K)

    # -- state ------------------------------------------------------------------
    def init_state(self, stacked_params):
        """Initial codec state (stacked EF residuals; None if stateless)."""
        if self.codec is None or not self.codec.stateful:
            return None
        return self.codec.init_state(stacked_params)

    def _on(self, name, make, device) -> torch.Tensor:
        """A constant table built by ``make()`` (numpy), cached per
        device."""
        key = (name, str(torch.device(device)))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(make(), device=device)
        return self._on_device[key]

    def sparse_structure(self, device):
        """(idx, sig) neighbour-lane tables of the sparse and sharded plans
        on ``device``, built once from the mix (indices checked in range)."""
        if self._structure_np is None:
            idx, sig = consensus.sparse_structure(self.mix)
            if idx.size and (idx.min() < 0 or idx.max() >= self.K):
                raise ValueError(f"neighbour index out of [0, {self.K})")
            self._structure_np = (idx, sig)
        return (self._on("idx", lambda: self._structure_np[0], device),
                self._on("sig", lambda: self._structure_np[1], device))

    # -- time-varying graphs ----------------------------------------------------
    def _sizes(self):
        return (np.ones(self.K, np.float32) if self.data_sizes is None
                else self.data_sizes)

    def round_mask(self, t, *, device=None):
        """(K, K) bool edge-survival mask of round ``t`` under this
        engine's graph process (None for a static graph); for a 1-D
        tensor of rounds, (R, K, K). Bit-identical to round ``t`` of the
        host :func:`repro_torch.core.topology.dropout` stream."""
        if self.graph.kind == "static":
            return None
        dev = _device(t, device)
        if self.graph.kind == "dropout":
            return topo_lib.survival_mask(
                self._adjacency, self.graph.p,
                self._on("graph_key",
                         lambda: topo_lib.survival_key(self.graph.seed), dev),
                t, symmetric=self._symmetric)
        masks = self._on("schedule", lambda: self.graph.masks, dev)
        tt = torch.as_tensor(t, dtype=torch.int64, device=dev)
        return (self._on("adjacency", lambda: self._adjacency, dev)
                & masks[tt % masks.shape[0]])

    def masked_mixing(self, mask):
        """Rebuild the (K, K) σ matrix on the surviving graph (bool mask
        or float lane weights) with the engine's mixing kind, data sizes
        and include_self."""
        sizes = self._on("sizes", self._sizes, mask.device)
        return consensus.mixing_weights_torch(
            sizes, mask, self.mix_kind, include_self=self.include_self)

    def lane_structure(self):
        """(idx, valid) neighbour-lane table of the BASE graph for the
        sparse and sharded plans, numpy: idx (K, H) int32 ascending
        neighbour indices (padding lanes index the agent itself), valid
        (K, H) bool marking real lanes."""
        if self._masked_struct is None:
            A = (np.asarray(self.topology.adjacency, bool).copy()
                 if self.topology is not None else self.mix != 0)
            np.fill_diagonal(A, False)
            idx, rows, _pos, _cols = consensus.neighbour_lanes(A)
            deg = np.bincount(rows, minlength=self.K)
            valid = np.arange(idx.shape[1])[None, :] < deg[:, None]
            self._masked_struct = (idx, valid)
        return self._masked_struct

    def schedule(self):
        """The distributed plan's permutation slots
        (:func:`repro_torch.core.consensus.permutation_schedule` of the
        engine's mix and γ), built once."""
        if self._schedule is None:
            self._schedule = consensus.permutation_schedule(self.mix,
                                                            self.gamma)
        return self._schedule

    def schedule_structure(self):
        """(srcs, real) of the distributed plan's schedule superset, numpy:
        srcs (M, K) int32, the position each target receives from in slot
        m; real (M, K) bool marking slots that carry a base-graph edge
        (the rest are completion padding, σ = 0 forever)."""
        if self._sched_struct is None:
            sched = self.schedule()
            srcs = consensus.schedule_sources(sched, self.K)
            real = np.zeros((len(sched), self.K), bool)
            for m, (_pairs, sig) in enumerate(sched):
                real[m] = np.asarray(sig) != 0.0
            self._sched_struct = (srcs, real)
        return self._sched_struct

    def _plan_lanes(self):
        """(receivers, senders, real) of this plan's survival shape, numpy:
        (K, 1) rows against the (K, H) lane table on the lane plans, (1, K)
        targets against the (M, K) schedule sources on distributed."""
        if self.plan.kind == "distributed":
            srcs, real = self.schedule_structure()
            return np.arange(self.K)[None, :], srcs, real
        idx, valid = self.lane_structure()
        return np.arange(self.K)[:, None], idx, valid

    def _senders(self, device) -> torch.Tensor:
        """The senders of this plan's survival shape as an int64 tensor
        on ``device``: lane neighbours (K, H) or slot sources (M, K)."""
        tag = "slot" if self.plan.kind == "distributed" else "lane"
        return self._on(f"{tag}_senders",
                        lambda: self._plan_lanes()[1].astype(np.int64),
                        device)

    def round_survival(self, t=None, mask=None, *, device=None):
        """Round ``t``'s edge survival in this plan's own shape: a (K, K)
        bool mask on the dense plan, surviving-lane (K, H) bools on the
        sparse and sharded plans, surviving-slot (M, K) bools on the
        distributed plan (never a (K, K) buffer on those). ``t`` may be a
        1-D tensor of rounds (a leading rounds axis is added: one
        vectorised draw for a whole chunk); ``mask`` instead converts an
        explicit (K, K) survival mask to the plan shape. None for a static
        graph with no explicit mask."""
        dev = (mask.device if isinstance(mask, torch.Tensor)
               else _device(t, device))
        kind = self.plan.kind
        if kind == "dense":
            return (torch.as_tensor(mask, device=dev) if mask is not None
                    else self.round_mask(t, device=dev))
        if mask is None and self.graph.kind == "static":
            return None
        rows_np, snd_np, real_np = self._plan_lanes()
        tag = "slot" if kind == "distributed" else "lane"
        snd = self._senders(dev)
        rows = self._on(f"{tag}_receivers", lambda: rows_np.astype(np.int64),
                        dev)
        if mask is not None:
            keep = torch.as_tensor(mask, device=dev)[..., rows, snd]
        elif self.graph.kind == "dropout":
            keep = topo_lib.survival_mask(
                self.K, self.graph.p,
                self._on("graph_key",
                         lambda: topo_lib.survival_key(self.graph.seed), dev),
                t, symmetric=self._symmetric, receivers=rows, senders=snd)
        else:                                        # schedule masks
            if self._sched_keep is None:
                self._sched_keep = np.asarray(
                    self.graph.masks[:, rows_np, snd_np])
            stack = self._on(f"{tag}_sched_keep", lambda: self._sched_keep,
                             dev)
            tt = torch.as_tensor(t, dtype=torch.int64, device=dev)
            keep = stack[tt % stack.shape[0]]
        return keep & self._on(f"{tag}_real", lambda: real_np, dev)

    # -- per-agent availability (the async protocol) ----------------------------
    def availability(self, t, *, device=None):
        """(K,) activity bools of round ``t`` (all True without agents=);
        (R, K) for a 1-D tensor of rounds. Bit-identical to the host
        :func:`repro_torch.core.topology.availability_stream` replay."""
        return topo_lib.agent_availability(self.agents, self.K, t,
                                           device=_device(t, device))

    def _real_edges(self):
        """Plan-shaped bool mask of the real base-graph lanes (numpy):
        the adjacency on the dense plan, lane validity on the sparse and
        sharded plans, real schedule slots on the distributed plan."""
        if self.plan.kind == "dense":
            return np.asarray(self.topology.adjacency, bool)
        return self._plan_lanes()[2]

    def _act_shapes(self, act):
        """(act_recv, act_sender) of the (K,) activity in this plan's
        survival shape: receiver rows and sender columns on (K, K),
        receiver rows and lane senders on (K, H), receiver columns and
        schedule sources on (M, K)."""
        kind = self.plan.kind
        if kind == "dense":
            return act[:, None], act[None, :]
        snd = self._senders(act.device)
        if kind == "distributed":
            return act[None, :], act[snd]
        return act[:, None], act[snd]

    def init_async_state(self, *, device=None) -> AsyncState:
        """Zeroed :class:`AsyncState` (clocks 0, every wire age 0: "all
        agents exchanged initial models at t = 0")."""
        if self.agents is None:
            raise ValueError(
                "init_async_state() is the async protocol's carry, but "
                f"this {self.plan.kind!r} engine has agents=None — pass "
                "agents=AgentProcess.bernoulli(p_active) (or another "
                "availability process) at construction")
        dev = _device(None, device)
        shape = np.asarray(self._real_edges()).shape
        return AsyncState(torch.zeros(self.K, dtype=torch.int32, device=dev),
                          torch.zeros(shape, dtype=torch.int32, device=dev))

    def async_round(self, t, age, *, act=None, link=None) -> AsyncRound:
        """Round ``t``'s availability facts against the wire ages ``age``.
        Per lane (receiver k ← sender h), with ``up`` the link's survival:

        * DELIVERED (``act[h] & act[k] & up``): weight 1, age resets to 0;
        * STALE (``act[k] & ~act[h]``, real lane): weight
          ``staleness_decay ** age`` until ``age > τ``, then 0;
        * otherwise weight 0.

        ``act`` and ``link`` pass this round's rows of draws already made
        for a whole chunk (:meth:`availability`, :meth:`round_survival`);
        without them the round is drawn here, on ``age``'s device."""
        if self.agents is None:
            raise ValueError(
                "async_round() needs an agents= AgentProcess attached "
                f"at construction, but this {self.plan.kind!r} engine "
                "has agents=None (it runs the lockstep protocol; use "
                "step(t=...) instead)")
        age = torch.as_tensor(age, dtype=torch.int32)
        dev = age.device
        if act is None:
            act = self.availability(t, device=dev)
        if link is None:
            link = self.round_survival(t, device=dev)
        act_recv, act_send = self._act_shapes(act)
        real = self._on("real", self._real_edges, dev)
        up = real if link is None else link
        delivered = act_send & act_recv & up
        new_age = torch.where(delivered, 0, age + 1)
        stale = act_recv & ~act_send & real
        if self.tau is not None:
            stale = stale & (new_age <= self.tau)
        one = torch.ones((), dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if self.staleness_decay == 1.0:
            stale_w = one
        else:
            decay = self._on("staleness_decay",
                             lambda: np.float32(self.staleness_decay), dev)
            stale_w = torch.pow(decay, new_age.to(torch.float32))
        weights = torch.where(delivered, one,
                              torch.where(stale, stale_w, zero))
        return AsyncRound(act, weights, delivered, new_age)

    def async_step(self, stacked_params, codec_state=None, generator=None,
                   *, t=None, state: Optional[AsyncState] = None,
                   round_info: Optional[AsyncRound] = None):
        """One async Eq.-(6) round: resolve availability, staleness-mix
        through :meth:`step`, freeze inactive agents' params and codec
        residuals, advance clocks and ages. Returns ``(params,
        codec_state, AsyncState, AsyncRound)``; ``round_info=`` reuses
        facts already drawn, else they are drawn from ``t``."""
        if state is None:
            raise ValueError(
                f"async_step at t={t!r} needs state= (the AsyncState "
                "carry, got state=None) — start from "
                "init_async_state() and thread each call's returned "
                "state into the next")
        ar = (round_info if round_info is not None
              else self.async_round(t, state.age))
        p, st = self.step(stacked_params, codec_state, generator,
                          survival=ar.weights)
        act = ar.act if self.local_rows is None else ar.act[self.local_rows]
        p = where_active(act, p, stacked_params)
        if st is not None:
            old = (codec_state if codec_state is not None
                   else self.init_state(stacked_params))
            st = where_active(act, st, old)
        new_state = AsyncState(state.clock + ar.act.to(state.clock.dtype),
                               ar.age)
        return p, st, new_state, ar

    def _lane_sigma(self, survival):
        """(idx, sig) for the sparse and sharded plans: σ renormalised
        directly on the
        surviving (K, H) lanes, the same formulas as ``mixing_weights``
        per entry, O(K·H). ``survival`` is bool lane keeps (lockstep) or
        float lane weights in [0, 1] (async: each lane's mass scales by
        its weight; {0, 1} floats give the bool path's bits). Faded,
        sleeping and padding lanes land at σ = 0."""
        keep = survival
        dev = keep.device
        idx = self._senders(dev)
        sizes = self._on("sizes", self._sizes, dev)
        weighted = keep.is_floating_point()
        if weighted:
            keep = keep.to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if self.mix_kind == "paper":
            w = (keep * sizes[idx] if weighted
                 else torch.where(keep, sizes[idx], zero))
            denom = w.sum(dim=1)
            if self.include_self:
                denom = denom + sizes
            sig = w / torch.clamp_min(denom, 1e-12)[:, None]
        elif self.mix_kind == "metropolis":
            deg = keep.sum(dim=1, dtype=torch.float32)
            inv = 1.0 / (1.0 + torch.maximum(deg[:, None], deg[idx]))
            sig = keep * inv if weighted else torch.where(keep, inv, zero)
        else:
            raise ValueError(consensus._unknown_kind_msg(self.mix_kind))
        return self._on("lane_idx32",
                        lambda: self.lane_structure()[0], dev), sig

    def _schedule_sigma(self, survival):
        """γ-scaled (K, M) slot σ for the distributed plan, renormalised on
        the surviving (M, K) slots: every real directed edge rides exactly
        one slot, so a target's sum over slots is its sum over neighbours.
        ``survival`` is bool slot keeps or float staleness weights ({0, 1}
        floats give the bool path's bits)."""
        keep = survival
        dev = keep.device
        srcs = self._senders(dev)
        sizes = self._on("sizes", self._sizes, dev)
        weighted = keep.is_floating_point()
        if weighted:
            keep = keep.to(torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if self.mix_kind == "paper":
            w = (keep * sizes[srcs] if weighted
                 else torch.where(keep, sizes[srcs], zero))
            denom = w.sum(dim=0)
            if self.include_self:
                denom = denom + sizes
            sig = w / torch.clamp_min(denom, 1e-12)[None, :]
        elif self.mix_kind == "metropolis":
            deg = keep.sum(dim=0, dtype=torch.float32)
            inv = 1.0 / (1.0 + torch.maximum(deg[None, :], deg[srcs]))
            sig = keep * inv if weighted else torch.where(keep, inv, zero)
        else:
            raise ValueError(consensus._unknown_kind_msg(self.mix_kind))
        return (self.gamma * sig).T

    def _schedule_sig_static(self, device):
        """The schedule's own (K, M) γ·σ stack on ``device``, built once."""
        def make():
            sched = self.schedule()
            if not sched:
                return np.zeros((self.K, 0), np.float32)
            return np.stack([sig for _, sig in sched], axis=1)
        return self._on("slot_sig", make, device)

    # -- the round --------------------------------------------------------------
    def step(self, stacked_params, codec_state=None, generator=None, *,
             t=None, mask=None, survival=None):
        """One Eq.-(6) round on agent-stacked params (a dict of (K, ...)
        tensors). Returns ``(params, codec_state)`` for every plan and
        codec (state None for codec-free rounds). ``generator`` enables
        stochastic rounding for quantizing codecs.

        Time-varying graphs: ``t`` draws the round's edge survival from
        the graph process, ``mask`` passes an explicit (K, K) survival
        mask, ``survival`` a plan-shaped operand already drawn
        (:meth:`round_survival`, or :meth:`async_round`'s weights). Each
        renormalises σ on the surviving edges."""
        kind = self.plan.kind
        device = next(iter(stacked_params.values())).device
        if self.agents is not None and survival is None:
            # deriving survival from t=/mask= here would ignore WHO is
            # awake: sleeping agents would mix at full weight
            raise ValueError(
                f"this engine carries an availability process "
                f"{self.agents!r}: step() needs the staleness-weighted "
                "survival from async_round(t, age).weights passed via "
                "survival= — or drive whole rounds through async_step()"
                " / scan_rounds(), which thread the (clock, age) "
                "AsyncState carry for you")
        if survival is None and (mask is not None or t is not None):
            survival = self.round_survival(t, mask=mask, device=device)
        if survival is None and self.graph.kind != "static":
            raise ValueError(
                f"this engine carries a time-varying {self.graph!r}: "
                "step() needs the round index (t=) or an explicit "
                "survival mask (mask=); use scan_rounds for whole "
                "round loops")
        mix, structure, slot_sig = self.mix, None, None
        if survival is not None:
            if kind == "dense":
                mix = self.masked_mixing(survival)
            elif kind == "distributed":
                slot_sig = self._schedule_sigma(survival)
            else:
                structure = self._lane_sigma(survival)
        elif kind in LANE_PLANS:
            structure = self.sparse_structure(device)
        elif kind == "distributed":
            slot_sig = self._schedule_sig_static(device)
        if kind == "sharded":
            return consensus.sharded_consensus_step(
                stacked_params, mix, num_blocks=self.plan.num_blocks,
                axis_name=self.plan.axis_name, mesh=self.mesh,
                codec=self.codec, codec_state=codec_state,
                generator=generator, gamma=self.gamma, error_feedback=False,
                structure=structure)
        if kind == "distributed":
            return consensus.distributed_consensus_step(
                stacked_params, mix, axis_name=self.plan.axis_name,
                mesh=self.mesh, codec=self.codec, codec_state=codec_state,
                generator=generator, gamma=self.gamma, error_feedback=False,
                schedule=self.schedule(), sig_override=slot_sig,
                sources=self._senders(device))
        dense_op = None
        if kind == "dense" and survival is None:
            # the static σ on the device, copied from the host once
            dense_op = (self._on("dense_effective",
                                 lambda: consensus._effective_mix(self.mix),
                                 device)
                        if self.codec is None else
                        self._on("dense_mix",
                                 lambda: np.asarray(self.mix, np.float32),
                                 device))
        if self.codec is None:
            return consensus.consensus_step(
                stacked_params, mix, impl=kind, structure=structure,
                dense_operator=dense_op), None
        # error_feedback=False: self.codec is already resolved
        return consensus.consensus_step(
            stacked_params, mix, impl=kind, codec=self.codec,
            codec_state=codec_state, generator=generator, gamma=self.gamma,
            error_feedback=False, structure=structure,
            dense_operator=dense_op)

    def _round_fn(self, recorder, engine):
        """``consensus_round(carry, xs, generator) -> ((carry,), ys)``: one
        round of :meth:`scan_rounds` on ``carry = (params, codec_state,
        clock, age)`` (the :class:`AsyncState` halves None on lockstep
        engines), ``xs`` the round's ``t`` and its rows of the vectorised
        ``link`` and ``act`` draws; ``ys`` the packed telemetry row
        (``recorder``), else None. ``engine`` is this engine or a weak
        proxy of it, so a program the engine holds does not hold the
        engine."""
        is_async = self.agents is not None

        def consensus_round(carry, xs, generator):
            params, st, clock, age = carry
            if is_async:
                ar = engine.async_round(xs["t"], age, act=xs["act"],
                                        link=xs["link"])
                params, st, (clock, age), _ = engine.async_step(
                    params, st, generator, state=AsyncState(clock, age),
                    round_info=ar)
                sv, act, row_age = ar.delivered, ar.act, ar.age
            else:
                params, st = engine.step(params, st, generator,
                                         survival=xs["link"])
                sv, act, row_age = xs["link"], None, None
            ys = None
            if recorder is not None:
                ys = recorder.pack([recorder.row(
                    params, sv, metric=0.0, reached=False, live=True,
                    active=act, age=row_age)])[0]
            return ((params, st, clock, age),), ys

        return consensus_round

    def round_program(self, stacked_params, codec_state=None,
                      generator=None, telemetry=None):
        """The round :meth:`scan_rounds` replays for these arguments: a
        :func:`repro_torch.core.scanloop.donating_graph` (argument 0, the
        carry, donated; ``async_argnums`` set on async engines) held by
        this engine and keyed on the params' and codec state's tree
        signatures, their device, ``telemetry.trace_signature()`` and
        whether a generator is passed. It obeys the program layer's byte
        rule; its ``held_bytes`` show in ``scanloop.cache_stats()`` under
        ``scan_rounds_held_bytes``, never in the drivers' cache (the JAX
        package's ``scan_rounds`` never touches its program cache).
        Streaming telemetry builds the program per call and holds none,
        as the drivers do. On a meshed engine (``local_rows`` set) the
        carry is this rank's rows and the round's collectives (the
        consensus wire, the row's disagreement all-reduces) run on the
        agent axis's group, captured with the round on NCCL
        (``scanloop.donating_graph(group=)``)."""
        streaming = telemetry is not None and telemetry.streaming
        device = next(iter(stacked_params.values())).device
        key = ("scan_rounds", str(device),
               scanloop.tree_signature(stacked_params),
               scanloop.tree_signature(codec_state),
               None if telemetry is None else telemetry.trace_signature(),
               generator is not None)
        prog = None if streaming else self._round_programs.get(key)
        if prog is None:
            from repro_torch.telemetry.buffer import RoundRecorder
            engine = weakref.proxy(self)
            # the program's own row maker, on the proxy: the telemetry's
            # recorder holds the engine, and the rows are the same
            rec = (None if telemetry is None
                   else RoundRecorder(engine, telemetry.energy_params))
            prog = scanloop.donating_graph(
                self._round_fn(rec, engine), donate_argnums=(0,),
                name="scan_rounds", count_traces=False, group=self.group)
            prog.record.streaming = streaming
            # the carry (argument 0) holds the AsyncState's clock and ages
            prog.record.async_argnums = ((0,) if self.agents is not None
                                         else ())
            if not streaming:
                prog.record.cache_key = key
                self._round_programs[key] = prog
        return prog

    def program_records(self):
        """The records of the round programs this engine holds."""
        return [p.record for p in self._round_programs.values()]

    def scan_rounds(self, stacked_params, codec_state=None, generator=None,
                    *, rounds: Optional[int] = None, t0: int = 0,
                    telemetry=None):
        """Run rounds ``t0 .. t0 + rounds - 1`` as ``rounds`` replays of
        one round program (:meth:`round_program`): :meth:`step`
        (lockstep) or :meth:`async_step` (async, from a fresh
        :class:`AsyncState` each call). The rounds' survival and
        availability are drawn first, in one vectorised call each on the
        params' device, and each round takes its rows of them as device
        tensors. The caller's params and codec state are copied before the
        first round (:func:`repro_torch.core.scanloop.own`), so they stay
        valid; the returned ones are the program's carry, copied out.
        Returns ``(params, codec_state)``, the same bits as the same calls
        made one by one, captured or not (``scanloop.uncaptured()``).

        ``telemetry`` (:class:`repro_torch.telemetry.Telemetry`) records
        one ``consensus`` row per round from the survival lanes the round
        mixed with (on async rounds ``AsyncRound.delivered``, activity and
        ages; never a second draw), packed inside the round and copied
        into an (R, cols) float64 buffer on the device, read from the
        device in one copy at the end (streaming mode: each row read after
        its round's replay). Params and state are bit-identical with
        telemetry off, buffered or streaming. On a mesh ``stacked_params``
        is this process's rows, the round program is held the same way
        (its collectives captured with it on NCCL), and every rank records
        the same rows (:meth:`audit_meta` names the disagreement's
        all-reduces)."""
        if rounds is None:
            raise ValueError(
                f"scan_rounds got rounds={rounds!r} — pass rounds= (a "
                "round count); stochastic rounding takes one generator= "
                "for all of them")
        if codec_state is None:
            codec_state = self.init_state(stacked_params)
        device = next(iter(stacked_params.values())).device
        R, is_async = int(rounds), self.agents is not None
        ts = torch.arange(int(t0), int(t0) + R, device=device)
        links = (self.round_survival(ts) if self.graph.kind != "static"
                 else None)
        acts = self.availability(ts) if is_async else None
        recorder = (telemetry.recorder_for(self) if telemetry is not None
                    else None)
        stream = (telemetry.stream_cb(recorder, "consensus")
                  if telemetry is not None and telemetry.streaming else None)
        program = self.round_program(stacked_params, codec_state, generator,
                                     telemetry)
        clock, age = (self.init_async_state(device=device) if is_async
                      else (None, None))
        carry = scanloop.own((stacked_params, codec_state)) + (clock, age)
        rows = None
        for i in range(R):
            xs = {"t": ts[i], "link": None if links is None else links[i],
                  "act": None if acts is None else acts[i]}
            (carry,), ys = program(carry, xs, generator)
            if recorder is not None:
                if rows is None:
                    rows = torch.empty((R, ys.shape[0]), dtype=torch.float64,
                                       device=device)
                rows[i].copy_(ys)
                if stream is not None:
                    stream(int(t0) + i, rows[i])
        if rows is not None:
            telemetry.record_rounds(
                recorder, recorder.unpack(scanloop.to_host(rows)), t0,
                driver="consensus")
        p, st = scanloop.own(carry[:2])
        return p, st

    # -- Eq.-(11) pricing -------------------------------------------------------
    def round_comm_joules(self, energy_params, model_bits=None) -> float:
        """Eq.-(11) communication energy of ONE round at this engine's
        wire format (the topology's codec-aware pricing)."""
        if self.topology is None:
            raise ValueError(
                f"this {self.plan.kind!r} engine was built from a raw "
                f"{self.mix.shape} mix matrix, which carries no link "
                "classes to bill; construct it from a Topology")
        return self.topology.round_comm_joules(
            energy_params, model_bits=model_bits, codec=self.codec)

    # -- audit metadata ---------------------------------------------------------
    def audit_meta(self, per_agent=None) -> dict:
        """Resolved facts :mod:`repro_torch.analysis.costmodel` keys its
        checks on: the plan's :data:`PLAN_AUDIT_EXPECTATIONS` entry, the
        plan kind, K, blocks, the mesh axis size (None without a mesh), the
        wire codec's name and its base codec's int-lane width, the
        topology's per-class directed message counts (``link_classes``,
        None for a raw mix) and ``priced_collectives``: each c10d op that
        carries the Eq.-(11)-billed wire, mapped to those counts. Every
        other collective a round runs must be control plane (rule C3).

        On a mesh (``local_rows`` not None) also ``observer_collectives``:
        the collectives the drivers and telemetry add to read the whole
        population, none of them a model exchange, each ``{"op",
        "quantity", "bytes"}`` with the bytes one call carries for agents
        shaped like ``per_agent`` (one agent's tensors; None without it):
        the gather that hands ``target_fn`` the population (K agents'
        bytes, once per evaluated round), the disagreement's two
        all-reduces (every leaf's f32 column sums, and the (K,) f32
        distances; once per telemetry row) and ``train_federated``'s
        broadcast of agent 0's logged loss (one f32, once per round). C3
        books them on a line of their own and never in the Eq.-(11)
        bill."""
        base = (getattr(self.codec, "inner", self.codec)
                if self.codec is not None else None)
        meta = dict(PLAN_AUDIT_EXPECTATIONS[self.plan.kind])
        link_classes = (None if self.topology is None else {
            k: v for k, v in self.topology.links_per_round().items()
            if k != "NONE"})
        meta.update(
            plan=self.plan.kind, K=self.K,
            num_blocks=self.plan.num_blocks,
            axis_name=self.plan.axis_name,
            mesh_axis=consensus.mesh_axis_size(self.mesh,
                                               self.plan.axis_name),
            codec=None if self.codec is None else self.codec.name,
            qbits=getattr(base, "qbits", None),
            link_classes=link_classes,
            priced_collectives={op: link_classes
                                for op in meta["wire_collective"] or ()},
        )
        if self.local_rows is not None:
            def size(f):
                return (None if per_agent is None else
                        sum(f(x) for x in per_agent.values()))
            agent_bytes = size(lambda x: x.numel() * x.element_size())
            n = size(lambda x: x.numel())
            meta["observer_collectives"] = [
                dict(op="allgather_", quantity="population for target_fn",
                     bytes=None if n is None else self.K * agent_bytes),
                dict(op="allreduce_", quantity="disagreement column sums",
                     bytes=None if n is None else 4 * n),
                dict(op="allreduce_", quantity="disagreement distances",
                     bytes=4 * self.K),
                dict(op="broadcast_", quantity="logged loss of agent 0",
                     bytes=4),
            ]
        return meta

    @classmethod
    def wrap(cls, obj, **kw) -> "ConsensusEngine":
        """Coerce ``obj`` (engine, Topology, or mix) to an engine; extra
        kwargs only apply when constructing a new one."""
        if isinstance(obj, cls):
            if any(v is not None for v in kw.values()):
                raise ValueError(
                    f"{sorted(k for k, v in kw.items() if v is not None)} "
                    "cannot be re-specified for an existing engine")
            return obj
        return cls(obj, **kw)

    def __repr__(self):
        codec = self.codec.name if self.codec is not None else None
        graph = ("" if self.graph.kind == "static"
                 else f", graph={self.graph!r}")
        agents = "" if self.agents is None else (
            f", agents={self.agents!r}, tau="
            f"{'inf' if self.tau is None else self.tau}")
        return (f"ConsensusEngine(K={self.K}, plan={self.plan.kind!r}, "
                f"codec={codec!r}, blocks={self.plan.num_blocks}"
                f"{graph}{agents})")
