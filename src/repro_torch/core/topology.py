"""Communication-graph topology — WHO talks to WHOM in one Eq.-(6)
consensus round and WHAT each message costs under Eq. (11).

A :class:`Topology` gives, for K agents: ``adjacency`` ((K, K) bool,
``A[k, h]`` ⇒ k consumes h's model), ``mixing()`` (the σ matrix of
Eq. 6), ``links_per_round`` (directed messages by link class) and
``round_comm_joules`` (the Eq.-(11) term of ONE round, per link class,
optionally per edge and per codec).

Link classes (Sect. III-B): ``SL`` device↔device sidelink, ``UL``
device→infrastructure uplink, ``DL`` infrastructure→device downlink.

Static graphs only; time-varying graph processes are not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import consensus, energy

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
        return bool((self.adjacency == self.adjacency.T).all())

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
