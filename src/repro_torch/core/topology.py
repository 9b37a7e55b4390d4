"""Communication-graph topology — WHO talks to WHOM in one Eq.-(6)
consensus round and WHAT each message costs under Eq. (11).

A :class:`Topology` gives, for K agents: ``adjacency`` ((K, K) bool,
``A[k, h]`` ⇒ k consumes h's model), ``mixing()`` (the σ matrix of
Eq. 6), ``links_per_round`` (directed messages by link class) and
``round_comm_joules`` (the Eq.-(11) term of ONE round, per link class,
optionally per edge and per codec).

Link classes (Sect. III-B): ``SL`` device↔device sidelink, ``UL``
device→infrastructure uplink, ``DL`` infrastructure→device downlink.

Time-varying graphs and per-agent availability: :class:`GraphProcess`
(per-round link survival) and :class:`AgentProcess` (who is awake each
round) draw through exactly two functions, :func:`survival_mask` and
:func:`availability_mask`, whose threefry draws (:mod:`repro_torch.core.
prng`) are bit-identical to the JAX package's on every device. So the
host replays (:func:`dropout`, :func:`availability_stream`) that bill
Eq. (11) after the fact equal the masks drawn on the card during the
rounds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import consensus, energy, prng

# link efficiency classes (Sect. III-B)
NONE, SL, UL, DL = 0, 1, 2, 3
LINK_CLASS_NAMES = {SL: "SL", UL: "UL", DL: "DL"}


@dataclass(frozen=True, eq=False)   # eq=False: ndarray fields
class Topology:
    """An immutable communication graph with per-link efficiency classes.

    ``adjacency[k, h]`` — agent k receives agent h's model each round.
    ``link_class[k, h]`` — class of that h → k message (SL/UL/DL); NONE
    exactly where ``adjacency`` is False. ``edge_efficiency`` — optional
    (K, K) per-edge bit/J overriding the class constant where > 0.
    """

    name: str
    adjacency: np.ndarray
    link_class: np.ndarray
    meta: dict = field(default_factory=dict)
    edge_efficiency: Optional[np.ndarray] = None

    def __post_init__(self):
        A = np.asarray(self.adjacency, bool)
        L = np.asarray(self.link_class, np.int8)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"adjacency must be square, got {A.shape}")
        if L.shape != A.shape:
            raise ValueError(f"link_class shape {L.shape} != {A.shape}")
        if A.diagonal().any():
            raise ValueError(
                f"adjacency has self loops at agents "
                f"{np.flatnonzero(A.diagonal()).tolist()} — zero the "
                "diagonal (self-mixing is the σ diagonal's job)")
        if ((L != NONE) != A).any():
            raise ValueError(
                f"link_class disagrees with adjacency on "
                f"{int(((L != NONE) != A).sum())} entries — set a class "
                "(SL/UL/DL) exactly on edges and NONE exactly off them")
        object.__setattr__(self, "adjacency", A)
        object.__setattr__(self, "link_class", L)
        if self.edge_efficiency is not None:
            E = np.asarray(self.edge_efficiency, np.float64)
            if E.shape != A.shape:
                raise ValueError(
                    f"edge_efficiency shape {E.shape} != {A.shape}")
            if (E < 0).any():
                raise ValueError(
                    f"edge efficiencies must be >= 0 bit/J, got min "
                    f"{E.min()} — fix the negative entries or drop "
                    "edge_efficiency= for class-constant pricing")
            if (E[~A] != 0).any():
                raise ValueError(
                    f"edge_efficiency has {int((E[~A] != 0).sum())} "
                    "nonzero entries off the edge set — mask it with "
                    "the adjacency")
            object.__setattr__(self, "edge_efficiency", E)

    # -- structure ------------------------------------------------------------
    @property
    def K(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """In-degree |N_k| per agent."""
        return self.adjacency.sum(axis=1)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.K else 0

    @property
    def directed_links(self) -> int:
        """Total directed messages per consensus round (Σ_k |N_k|)."""
        return int(self.adjacency.sum())

    @property
    def is_symmetric(self) -> bool:
        return consensus.is_symmetric(self.adjacency)

    def neighbors_of(self, k: int) -> List[int]:
        return list(np.flatnonzero(self.adjacency[k]))

    def is_connected(self) -> bool:
        """Weak connectivity (BFS over the undirected support)."""
        if self.K == 0:
            return True
        und = self.adjacency | self.adjacency.T
        seen = np.zeros(self.K, bool)
        frontier = [0]
        seen[0] = True
        while frontier:
            nxt = np.flatnonzero(und[frontier].any(axis=0) & ~seen)
            seen[nxt] = True
            frontier = list(nxt)
        return bool(seen.all())

    # -- mixing (Eq. 6) -------------------------------------------------------
    def mixing(self, data_sizes: Optional[Sequence[float]] = None,
               kind: str = "paper", include_self: bool = True) -> np.ndarray:
        """(K, K) float32 σ matrix of Eq. (6) on this graph."""
        sizes = np.ones(self.K) if data_sizes is None else data_sizes
        return consensus.mixing_weights(sizes, self.adjacency, kind,
                                        include_self=include_self)

    # -- Eq. (11) link pricing ------------------------------------------------
    def links_per_round(self) -> Dict[str, int]:
        """Directed message counts per round, keyed by link class."""
        return {name: int((self.link_class == cls).sum())
                for cls, name in LINK_CLASS_NAMES.items()}

    def with_edge_efficiency(self, eff) -> "Topology":
        """Copy with per-edge efficiencies (bit/J; (K, K) or a scalar)."""
        eff = np.asarray(eff, np.float64)
        if eff.ndim == 0:
            eff = np.where(self.adjacency, float(eff), 0.0)
        return dataclasses.replace(self, edge_efficiency=eff)

    def round_comm_joules(self, p: energy.EnergyParams,
                          model_bits: Optional[float] = None,
                          codec=None) -> float:
        """Eq.-(11) communication energy of ONE consensus round: every
        directed message carries b(W) bits (``codec.price_bits(b(W))``
        with a codec) at its class's (or edge's) efficiency."""
        bits = p.model_bits if model_bits is None else model_bits
        if codec is not None:
            from repro_torch.comms import codecs   # deferred: import cycle
            bits = codecs.get_codec(codec).price_bits(bits)
        if self.edge_efficiency is None:
            n = self.links_per_round()
            return bits * (n["SL"] * energy.sidelink_cost_per_bit(p)
                           + n["UL"] / p.E_UL + n["DL"] / p.E_DL)
        class_cost = np.zeros(self.adjacency.shape)
        class_cost[self.link_class == SL] = energy.sidelink_cost_per_bit(p)
        class_cost[self.link_class == UL] = 1.0 / p.E_UL
        class_cost[self.link_class == DL] = 1.0 / p.E_DL
        eff = self.edge_efficiency
        cost = np.where(eff > 0, 1.0 / np.maximum(eff, 1e-300), class_cost)
        return float(bits * cost[self.adjacency].sum())

    def __repr__(self):
        lk = {k: v for k, v in self.links_per_round().items() if v}
        return (f"Topology({self.name!r}, K={self.K}, "
                f"max_degree={self.max_degree}, links={lk})")


# -- construction helpers -------------------------------------------------------


def _from_edges(name: str, K: int, edges, cls_of=None, meta=None) -> Topology:
    """Build from directed (receiver, sender) pairs."""
    A = np.zeros((K, K), bool)
    L = np.zeros((K, K), np.int8)
    for k, h in edges:
        if k == h:
            continue
        A[k, h] = True
        L[k, h] = SL if cls_of is None else cls_of(k, h)
    return Topology(name, A, L, meta or {})


def _symmetric(name: str, K: int, pairs, cls: int = SL, meta=None) -> Topology:
    edges = [(k, h) for k, h in pairs] + [(h, k) for k, h in pairs]
    return _from_edges(name, K, edges, lambda *_: cls, meta)


def ring(K: int, hops: int = 1) -> Topology:
    """Symmetric ring; each agent sees ``hops`` neighbours each side (SL)."""
    A = consensus.ring_adjacency(K, hops)
    return Topology("ring", A, np.where(A, SL, NONE).astype(np.int8),
                    {"hops": hops})


def full(K: int) -> Topology:
    """All-to-all sidelink mesh."""
    A = consensus.full_adjacency(K)
    return Topology("full", A, np.where(A, SL, NONE).astype(np.int8))


def torus(rows: int, cols: int) -> Topology:
    """2-D 4-neighbour torus (rows × cols agents, SL links)."""
    K = rows * cols
    pairs = set()
    for r in range(rows):
        for c in range(cols):
            k = r * cols + c
            for rr, cc in ((r, (c + 1) % cols), ((r + 1) % rows, c)):
                h = rr * cols + cc
                if h != k:
                    pairs.add((min(k, h), max(k, h)))
    return _symmetric("torus", K, pairs, meta={"rows": rows, "cols": cols})


def small_world(K: int, k: int = 4, rewire_p: float = 0.1,
                seed: int = 0) -> Topology:
    """Watts–Strogatz: ring(K, k/2) with each edge rewired with prob. p
    (numpy RNG, so the graph is the JAX package's exactly)."""
    if k % 2 or not 0 < k < K:
        raise ValueError(f"need even 0 < k < K, got k={k} K={K}")
    rng = np.random.default_rng(seed)
    pairs = {(kk, (kk + d) % K) for kk in range(K) for d in range(1, k // 2 + 1)}
    pairs = {(min(a, b), max(a, b)) for a, b in pairs}
    out = set(pairs)
    for a, b in sorted(pairs):
        if rng.random() < rewire_p:
            c = int(rng.integers(K))
            new = (min(a, c), max(a, c))
            if c != a and new not in out:
                out.discard((a, b))
                out.add(new)
    return _symmetric("small_world", K, out,
                      meta={"k": k, "rewire_p": rewire_p, "seed": seed})


def star(K: int) -> Topology:
    """FedAvg star: agent 0 is the hub; leaves upload over UL and
    receive the hub's model over DL."""
    edges, cls = [], {}
    for leaf in range(1, K):
        edges.append((0, leaf))
        edges.append((leaf, 0))
        cls[(0, leaf)] = UL
        cls[(leaf, 0)] = DL
    return _from_edges("star", K, edges, lambda kk, h: cls[(kk, h)])


def clusters(num_clusters: int, devices_per_cluster: int) -> Topology:
    """The paper's per-task clusters C_i: all-to-all SL within a cluster,
    no inter-cluster links (Sect. II-B)."""
    per = devices_per_cluster
    K = num_clusters * per
    pairs = {(c * per + i, c * per + j)
             for c in range(num_clusters)
             for i in range(per) for j in range(i + 1, per)}
    return _symmetric("cluster", K, pairs,
                      meta={"num_clusters": num_clusters,
                            "devices_per_cluster": per})


def hierarchical(num_clusters: int, devices_per_cluster: int) -> Topology:
    """Clusters plus each cluster's first device as gateway on an
    inter-cluster ring (backhaul priced as UL)."""
    per = devices_per_cluster
    base = clusters(num_clusters, per)
    A = base.adjacency.copy()
    L = base.link_class.copy()
    if num_clusters > 1:
        gws = [c * per for c in range(num_clusters)]
        for i, g in enumerate(gws):
            for d in (1, -1):
                h = gws[(i + d) % num_clusters]
                if h != g:
                    A[g, h] = True
                    L[g, h] = UL
    return Topology("hierarchical", A, L,
                    {"num_clusters": num_clusters,
                     "devices_per_cluster": per})


def from_cluster_network(net) -> Topology:
    """Adapter for :class:`repro_torch.core.multitask.ClusterNetwork`."""
    return clusters(net.num_tasks, net.devices_per_cluster)


# -- time-varying topologies ----------------------------------------------------


def survival_key(seed: int, device=None) -> torch.Tensor:
    """The PRNG key a dropout :class:`GraphProcess` with this seed folds
    its round indices into (the shared fold-in convention)."""
    return prng.PRNGKey(seed, device)


def _round_keys(key, t, extra_dims: int) -> torch.Tensor:
    """``fold_in(key, t)`` for every round of ``t`` (int or a tensor of
    rounds), shaped to broadcast over ``extra_dims`` trailing axes."""
    tt = prng.as_u32(t, key.device)
    rk = prng.fold_in(key, tt)
    return rk.reshape(tt.shape + (1,) * extra_dims + (2,))


def survival_mask(adjacency, p: float, key, t, symmetric: Optional[bool]
                  = None, *, receivers=None, senders=None):
    """Edge-survival bools of round ``t``, the shared fold-in convention
    defined PER EDGE. Each directed edge (receiver ``i``, sender ``j``)
    owns one id, ``min(i,j)·K + max(i,j)`` on symmetric graphs (one draw
    per undirected pair: a faded channel kills both directions) or
    ``i·K + j`` on asymmetric ones, and survives round ``t`` iff

        ``uniform(fold_in(fold_in(key, t), edge_id)) >= p`` .

    Self loops never fade. ``p = 0`` keeps every edge, ``p = 1`` drops
    every non-self edge.

    Two call forms share this one draw site:

    * dense: ``survival_mask(adjacency, p, key, t)`` evaluates the
      convention on the whole (K, K) grid and returns ``adjacency & keep``;
    * per edge: ``survival_mask(K, p, key, t, symmetric=...,
      receivers=i, senders=j)`` evaluates it only at the given index
      arrays (broadcast together) and returns the raw keep bools of that
      shape, bit-identical to the dense grid at those entries. Callers
      AND with lane validity themselves; ``symmetric=`` is required.

    The draws run on ``key``'s device. ``t`` is a round index or a 1-D
    tensor of them; the result then gains a leading rounds axis, so a
    whole chunk of rounds is one vectorised draw.
    """
    dev = key.device
    A = None
    if receivers is not None or senders is not None:
        if receivers is None or senders is None:
            missing = "senders=" if senders is None else "receivers="
            raise ValueError(
                f"per-edge survival draws need BOTH receivers= and "
                f"senders=, but {missing} is None — pass both endpoint "
                "index arrays, or a full adjacency for the dense form")
        if symmetric is None:
            raise ValueError(
                f"per-edge survival draws over {np.shape(receivers)} "
                "endpoint arrays need an explicit symmetric= (there is "
                "no adjacency to infer pair-folding from) — pass "
                "symmetric=True for undirected links, False for "
                "directed")
        K = int(adjacency)
        sym = bool(symmetric)
        i, j = torch.broadcast_tensors(
            torch.as_tensor(receivers, dtype=torch.int64, device=dev),
            torch.as_tensor(senders, dtype=torch.int64, device=dev))
    else:
        A = np.asarray(adjacency, bool)
        K = A.shape[0]
        sym = bool((A == A.T).all()) if symmetric is None else bool(symmetric)
        ar = torch.arange(K, dtype=torch.int64, device=dev)
        i, j = ar[:, None].expand(K, K), ar[None, :].expand(K, K)
    rk = _round_keys(key, t, i.ndim)
    lo = torch.minimum(i, j) if sym else i
    hi = torch.maximum(i, j) if sym else j
    eid = (lo * K + hi) & prng.MASK32
    u = prng.uniform(prng.fold_in(rk, eid))
    thresh = torch.tensor(float(p), dtype=torch.float32, device=dev)
    keep = (u >= thresh) | (i == j)
    if A is None:
        return keep
    return torch.as_tensor(A, device=dev) & keep


@dataclass(frozen=True)
class GraphProcess:
    """A time-varying communication-graph process: how the engine's σ
    evolves round over round, resolved once at
    :class:`repro_torch.core.engine.ConsensusEngine` construction.

    * ``static()``         — the graph never changes (the default);
    * ``dropout(p, seed)`` — every round, each link of the base graph is
      independently DOWN with probability ``p``, drawn by
      :func:`survival_mask` from ``fold_in(PRNGKey(seed), round)``;
    * ``schedule(masks)``  — an explicit (R, K, K) bool stack of keep
      masks; round ``t`` applies ``masks[t % R]``.

    Each round's σ is renormalised on the surviving graph (self loops
    kept, the mass of dropped links reallocated by the mixing kind),
    never silently zeroed.
    """

    kind: str = "static"                  # static | dropout | schedule
    p: float = 0.0
    seed: int = 0
    masks: Optional[np.ndarray] = None    # (R, K, K) for "schedule"

    def __post_init__(self):
        if self.kind not in ("static", "dropout", "schedule"):
            raise ValueError(f"unknown graph process {self.kind!r}")
        if self.kind == "dropout" and not 0 <= self.p < 1:
            raise ValueError(
                f"dropout probability must be in [0, 1), got {self.p}")
        if self.kind == "schedule":
            m = np.asarray(self.masks, bool)
            if m.ndim != 3 or m.shape[1] != m.shape[2] or not m.shape[0]:
                raise ValueError(
                    f"schedule masks must be (R, K, K), got {m.shape}")
            object.__setattr__(self, "masks", m)

    @staticmethod
    def static() -> "GraphProcess":
        return GraphProcess("static")

    @staticmethod
    def dropout(p: float, seed: int = 0) -> "GraphProcess":
        return GraphProcess("dropout", p=float(p), seed=int(seed))

    @staticmethod
    def schedule(masks) -> "GraphProcess":
        return GraphProcess("schedule", masks=masks)

    def __repr__(self):
        if self.kind == "dropout":
            return f"GraphProcess.dropout(p={self.p}, seed={self.seed})"
        if self.kind == "schedule":
            return f"GraphProcess.schedule(R={self.masks.shape[0]})"
        return "GraphProcess.static()"


def dropout(topo: Topology, p: float, seed: int = 0,
            rounds: Optional[int] = None):
    """Per-round link-dropout sequence on the host: round ``r``'s keep
    mask is :func:`survival_mask` at ``fold_in(PRNGKey(seed), r)``, the
    same convention a ``GraphProcess.dropout(p, seed)`` engine draws on
    the card, so this stream and the engine's masks are bit-identical.
    Symmetric graphs drop whole undirected pairs; asymmetric edges drop
    per directed edge. Surviving links keep their class and any per-edge
    efficiency.

    With ``rounds`` returns a list of ``rounds`` Topologies; without, an
    infinite generator. Deterministic in ``seed``.
    """
    if not 0 <= p < 1:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")

    def _rounds():
        key = survival_key(seed)
        sym = topo.is_symmetric
        r = 0
        while True:
            mask = survival_mask(topo.adjacency, p, key, r,
                                 symmetric=sym).numpy()
            eff = (None if topo.edge_efficiency is None
                   else np.where(mask, topo.edge_efficiency, 0.0))
            yield Topology(
                f"{topo.name}~drop", mask,
                np.where(mask, topo.link_class, NONE).astype(np.int8),
                {**topo.meta, "dropout_p": p, "dropout_seed": seed,
                 "round": r},
                edge_efficiency=eff)
            r += 1

    gen = _rounds()
    if rounds is None:
        return gen
    return [next(gen) for _ in range(rounds)]


# -- per-agent availability (the async protocol's churn source) -----------------


def availability_key(seed: int, device=None) -> torch.Tensor:
    """Root PRNG key of a per-agent availability stream."""
    return prng.PRNGKey(seed, device)


def availability_mask(K, p_inactive, key, t, *, agents=None):
    """Per-agent activity bools of round ``t``, the agent half of the
    fold-in convention (the link half is :func:`survival_mask`). Agent
    ``k`` is ACTIVE in round ``t`` iff

        ``uniform(fold_in(fold_in(key, t), k)) >= p_inactive_k`` .

    ``p_inactive`` is a scalar or a (K,) vector of per-agent sleep
    probabilities; ``agents=`` restricts the draw to the given agent ids
    (any shape), bit-identical to those entries of the full (K,) draw.
    The draws run on ``key``'s device; ``t`` is a round index or a 1-D
    tensor of them (a leading rounds axis is added).
    """
    dev = key.device
    ids = (torch.arange(int(K), dtype=torch.int64, device=dev)
           if agents is None
           else torch.as_tensor(agents, dtype=torch.int64, device=dev))
    p = torch.as_tensor(p_inactive, dtype=torch.float32, device=dev)
    thresh = p if p.ndim == 0 else p[ids]
    rk = _round_keys(key, t, ids.ndim)
    u = prng.uniform(prng.fold_in(rk, ids))
    return u >= thresh


@dataclass(frozen=True)
class AgentProcess:
    """A per-agent availability process: WHO participates each round,
    the companion of :class:`GraphProcess` (which says which LINKS are
    up). Per-round activity is drawn by :func:`agent_availability`:

    * ``always_on()``          — every agent, every round (lockstep; with
      τ = ∞ the async engine reduces to it bit for bit);
    * ``bernoulli(p_active)``  — each agent awake each round with
      probability ``p_active``;
    * ``straggler(K, ...)``    — per-agent sleep probabilities drawn on
      the host at construction from a Pareto(``tail``) tail;
    * ``arrival(t_join)``      — agent ``k`` active iff ``t >= t_join[k]``;
    * ``departure(t_leave)``   — agent ``k`` active iff ``t < t_leave[k]``.

    An inactive agent neither runs local SGD nor sends or receives wires
    that round: its params, codec residuals and round clock freeze, and
    its neighbours mix its last-published state at decayed weight until
    the wire age passes the engine's bound τ.
    """

    kind: str = "always_on"   # always_on | bernoulli | straggler
                              # | arrival | departure
    p_active: float = 1.0
    seed: int = 0
    rates: Optional[np.ndarray] = None     # (K,) sleep probs, straggler
    t_join: Optional[np.ndarray] = None    # (K,) int rounds, arrival
    t_leave: Optional[np.ndarray] = None   # (K,) int rounds, departure

    def __post_init__(self):
        kinds = ("always_on", "bernoulli", "straggler", "arrival",
                 "departure")
        if self.kind not in kinds:
            raise ValueError(
                f"unknown agent process {self.kind!r}; choose from "
                f"{kinds} (see AgentProcess's constructors)")
        if self.kind == "bernoulli" and not 0 <= self.p_active <= 1:
            raise ValueError(
                f"bernoulli duty cycle p_active must be in [0, 1], got "
                f"{self.p_active}")
        if self.kind == "straggler":
            r = np.asarray(self.rates, np.float64)
            if r.ndim != 1 or not r.size:
                raise ValueError(
                    f"straggler rates must be a non-empty (K,) vector "
                    f"of per-agent sleep probabilities, got shape "
                    f"{r.shape}")
            if not ((r >= 0) & (r <= 1)).all():
                raise ValueError(
                    "straggler rates must all lie in [0, 1], got "
                    f"min={r.min()} max={r.max()}")
            object.__setattr__(self, "rates", r)
        for name in ("t_join", "t_leave"):
            v = getattr(self, name)
            if v is None:
                continue
            v = np.asarray(v, np.int64)
            if v.ndim != 1 or not v.size:
                raise ValueError(
                    f"{name} must be a non-empty (K,) vector of round "
                    f"indices, got shape {v.shape}")
            object.__setattr__(self, name, v)

    @property
    def K(self) -> Optional[int]:
        """Population size the process pins, or None if size-free."""
        for v in (self.rates, self.t_join, self.t_leave):
            if v is not None:
                return int(v.shape[0])
        return None

    @staticmethod
    def always_on() -> "AgentProcess":
        return AgentProcess("always_on")

    @staticmethod
    def bernoulli(p_active: float, seed: int = 0) -> "AgentProcess":
        return AgentProcess("bernoulli", p_active=float(p_active),
                            seed=int(seed))

    @staticmethod
    def straggler(K: int, *, tail: float = 1.1, scale: float = 0.05,
                  cap: float = 0.9, seed: int = 0,
                  rates=None) -> "AgentProcess":
        """Heavy-tail straggler fleet: per-agent sleep probability
        ``min(cap, scale · Pareto(tail))`` drawn on the host from
        ``seed`` (pass ``rates=`` to pin them instead)."""
        if rates is None:
            rng = np.random.default_rng(seed)
            rates = np.minimum(float(cap),
                               float(scale) * rng.pareto(float(tail),
                                                         size=int(K)))
        return AgentProcess("straggler", seed=int(seed), rates=rates)

    @staticmethod
    def arrival(t_join) -> "AgentProcess":
        return AgentProcess("arrival", t_join=t_join)

    @staticmethod
    def departure(t_leave) -> "AgentProcess":
        return AgentProcess("departure", t_leave=t_leave)

    def __repr__(self):
        if self.kind == "bernoulli":
            return (f"AgentProcess.bernoulli(p_active={self.p_active}, "
                    f"seed={self.seed})")
        if self.kind == "straggler":
            return (f"AgentProcess.straggler(K={self.K}, "
                    f"seed={self.seed})")
        if self.kind == "arrival":
            return f"AgentProcess.arrival(K={self.K})"
        if self.kind == "departure":
            return f"AgentProcess.departure(K={self.K})"
        return "AgentProcess.always_on()"


def agent_availability(process: Optional[AgentProcess], K: int, t,
                       device=None) -> torch.Tensor:
    """(K,) activity bools of round ``t`` under ``process`` (None means
    always on); for a 1-D tensor of rounds, (R, K). The one dispatch the
    engine's draws on the card and the host replay
    (:func:`availability_stream`) both go through. Runs on ``t``'s
    device when ``t`` is a tensor, else on ``device`` (default the
    CPU)."""
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(
        device if device is not None else "cpu")
    tt = torch.as_tensor(t, dtype=torch.int64, device=dev)
    if process is None or process.kind == "always_on":
        return torch.ones(tt.shape + (int(K),), dtype=torch.bool, device=dev)
    if process.kind == "bernoulli":
        return availability_mask(K, 1.0 - process.p_active,
                                 availability_key(process.seed, dev), tt)
    if process.kind == "straggler":
        return availability_mask(K, process.rates.astype(np.float32),
                                 availability_key(process.seed, dev), tt)
    if process.kind == "arrival":
        return tt[..., None] >= torch.as_tensor(process.t_join, device=dev)
    return tt[..., None] < torch.as_tensor(process.t_leave, device=dev)


def availability_stream(process: Optional[AgentProcess], K: int,
                        rounds: int) -> np.ndarray:
    """(rounds, K) bool host replay of ``process``: the same draws the
    engine makes on the card, which is how the post-hoc Eq.-(11) bill
    prices exactly the wires active agents sent."""
    return agent_availability(process, K, torch.arange(int(rounds))).numpy()


def _near_square(K: int):
    r = int(np.sqrt(K))
    while K % r:
        r -= 1
    return r, K // r


FAMILIES = ("ring", "full", "torus", "small_world", "star", "cluster",
            "hierarchical")


def make(name: str, K: int, **kw) -> Topology:
    """Build any family at population size K with sensible defaults."""
    if name == "ring":
        return ring(K, **kw)
    if name == "full":
        return full(K)
    if name == "torus":
        return torus(*_near_square(K))
    if name == "small_world":
        kw.setdefault("k", min(4, 2 * ((K - 1) // 2)))
        return small_world(K, **kw)
    if name == "star":
        return star(K)
    if name == "cluster":
        per = kw.pop("devices_per_cluster", 4 if K % 4 == 0 else 2)
        if K % per:
            raise ValueError(f"K={K} not divisible by cluster size {per}")
        return clusters(K // per, per)
    if name == "hierarchical":
        per = kw.pop("devices_per_cluster", 4 if K % 4 == 0 else 2)
        if K % per:
            raise ValueError(f"K={K} not divisible by cluster size {per}")
        return hierarchical(K // per, per)
    raise ValueError(f"unknown topology family {name!r}; "
                     f"choose from {FAMILIES}")
