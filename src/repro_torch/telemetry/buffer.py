"""Per-round metric rows on the device and the host-side ring buffer.

The round drivers (:mod:`repro_torch.core.federated`, the case study,
``ConsensusEngine.scan_rounds``) read the device once per chunk of rounds,
so per-round observability rides that read: each round builds one
fixed-shape ROW of tensors on the params' device, the chunk's rows are
packed beside the driver's own flags into the chunk's one device→host
copy, and the host prices them there. Rows READ the round's state and
never feed back into it, so round results are bit-identical with
telemetry on or off.

* :class:`RoundRecorder` — built per engine. :meth:`RoundRecorder.row`
  records what must be measured on the device: exact int32
  surviving-link counts per class, read from the same plan-shaped
  survival (or ``AsyncRound.delivered``) tensor the round mixed with —
  never a re-draw, and never a (K, K) buffer on the sparse plan — the
  consensus disagreement ‖x_i − x̄‖, the round's metric and its
  reached/live flags. Eq.-(11) joules and wire bits are priced on the
  host in :meth:`RoundRecorder.finalize`, in float64 with the LITERAL
  ``Topology.round_comm_joules`` expression, so the summed stream
  reconciles EXACTLY (``==``) with the case study's post-hoc replay.
* :class:`MetricBuffer` — the host ring buffer the finalized events land
  in; fixed capacity (oldest rounds dropped) or unbounded.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch.core import energy, scanloop
from repro_torch.core import topology as topo_lib

#: per-round row fields, in emission order. ``live`` marks real rounds
#: (False = a round the driver computed after the target was hit and then
#: discarded — zero links, excluded from ledgers and sinks).
#: ``n_active``/``max_age`` are the async (agent-availability) health
#: observables: how many agents took part, and the oldest wire any
#: receiver still mixes — K and 0 on lockstep rounds.
#: ``agent_sl``/``agent_ul``/``agent_dl`` are the only non-scalar rows:
#: (K,) int32 per-SENDER surviving-wire counts (``link_class[k, h]``
#: classes the h → k message, so the transmitting agent h pays), summing
#: exactly to the aggregate ``n_*`` counts and exactly zero for an agent
#: that slept or whose every link died.
ROW_FIELDS = ("live", "reached", "metric", "disagreement",
              "n_sl", "n_ul", "n_dl", "n_active", "max_age",
              "agent_sl", "agent_ul", "agent_dl")
_SCALAR_FIELDS = ROW_FIELDS[:9]
_AGENT_FIELDS = ROW_FIELDS[9:]
_CLASSES = (("SL", topo_lib.SL), ("UL", topo_lib.UL), ("DL", topo_lib.DL))


def consensus_disagreement(stacked):
    """Mean over agents of ‖x_i − x̄‖ (f32, all leaves flattened
    together) — the convergence observable of the consensus plans, taken
    on the POST-mix params so round r reports what its own mixing left."""
    leaves = list(stacked.values())
    K = leaves[0].shape[0]
    sq = torch.zeros((K,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        xf = x.to(torch.float32).reshape(K, -1)
        d = xf - xf.mean(dim=0, keepdim=True)
        sq = sq + (d * d).sum(dim=1)
    return sq.sqrt().mean()


def mesh_disagreement(stacked, engine):
    """:func:`consensus_disagreement` of the whole population on a meshed
    engine, from this rank's rows (``engine.local_rows``): an all-reduce
    of every leaf's column sums (one f32 vector) gives the population
    mean, and an all-reduce of the (K,) per-agent distances, each rank
    filling its own rows and zeros elsewhere, gives every distance, whose
    mean is taken as in one process. Every rank gets the same value. The
    mean's sums run in another order than one process's, so the value is
    held to :func:`disagreement_tolerance` of the one-process value.
    These are the two observer all-reduces
    ``ConsensusEngine.audit_meta()`` names; Eq. (11) does not bill them."""
    import torch.distributed as dist

    group = engine.mesh.get_group(engine.plan.axis_name)
    rows, K = engine.local_rows, engine.K
    leaves = [x.to(torch.float32).reshape(x.shape[0], -1)
              for x in stacked.values()]
    sums = torch.cat([x.sum(dim=0) for x in leaves])
    dist.all_reduce(sums, group=group)
    means = (sums / K).split([x.shape[1] for x in leaves])
    sq = torch.zeros((leaves[0].shape[0],), dtype=torch.float32,
                     device=sums.device)
    for x, m in zip(leaves, means):
        d = x - m
        sq = sq + (d * d).sum(dim=1)
    dists = torch.zeros((K,), dtype=torch.float32, device=sums.device)
    dists[rows] = sq.sqrt()
    dist.all_reduce(dists, group=group)
    return dists.mean()


def disagreement_tolerance(K: int, n: int, max_abs: float,
                           value: float) -> float:
    """Bound on |mesh - one process| of the disagreement of K agents of
    ``n`` params each, largest magnitude ``max_abs``: each column mean's
    f32 sum of K terms in another order moves it by at most K·eps·max|x|,
    a distance by at most √n times that, and the mean of the distances
    and their square roots add a few roundings of ``value``."""
    eps = float(np.finfo(np.float32).eps)
    return K * eps * max_abs * float(np.sqrt(n)) + 4 * eps * abs(value)


def _scalar(value, dtype, device):
    """A 0-d tensor of ``dtype`` on ``device`` (a fill, not a host copy,
    for Python scalars)."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype).reshape(())
    return torch.full((), value, dtype=dtype, device=device)


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class RoundRecorder:
    """Per-engine row maker (device) + event pricer (host, float64).

    Construction bakes the engine's billing constants the way the
    post-hoc replay computes them: ``bits`` = ``codec.price_bits(
    p.model_bits)`` (raw ``model_bits`` uncoded) and the class link masks
    from ``topology.link_class``, in the plan's own survival shape:
    (K, K) on the dense plan, (K, H) neighbour lanes on the sparse and
    sharded plans (padding lanes → NONE), (M, K) schedule slots on the
    distributed plan (completion slots → NONE). Every real directed edge appears exactly once
    in each shape, so the per-class counts are identical integers.
    Per-edge heterogeneous pricing (``edge_efficiency``) is refused —
    rows carry per-CLASS counts only.
    """

    def __init__(self, engine, energy_params=None):
        topo = getattr(engine, "topology", None)
        if topo is None:
            raise ValueError(
                "telemetry needs an engine built from a Topology (raw "
                "mixing matrices carry no link classes to bill)")
        if topo.edge_efficiency is not None:
            raise NotImplementedError(
                "per-edge efficiencies are priced post-hoc only; in-scan "
                "telemetry rows carry per-class counts")
        self.engine = engine
        self.topology = topo
        self.codec = engine.codec
        self.energy_params = (energy_params
                              or energy.paper_calibrated("fig3"))
        link_class = np.asarray(topo.link_class)
        if engine.plan.kind == "dense":
            table = link_class
            self._sender_index = None   # dense: sum over receivers
        else:
            # (K, H) lanes on the sparse and sharded plans (padding lanes
            # → NONE), (M, K) schedule slots on the distributed plan
            # (completion slots → NONE); per-SENDER attribution: each
            # position bills the sender it reads from
            rows, senders, real = engine._plan_lanes()
            table = np.where(real, link_class[rows, senders], topo_lib.NONE)
            self._sender_index = np.asarray(senders, np.int64)
        self._class_masks = {name: table == cls for name, cls in _CLASSES}
        # real lanes in the plan shape: max_age reads only these (padding
        # lanes never deliver, so their ages grow without meaning)
        self._real_mask = table != topo_lib.NONE
        self._static_counts = {name: int((link_class == cls).sum())
                               for name, cls in _CLASSES}
        K = topo.K
        self._static_agent_counts = {}
        for name, cls in _CLASSES:
            hit = table == cls
            if self._sender_index is None:
                per = hit.sum(axis=0)
            else:
                per = np.zeros((K,), np.int64)
                np.add.at(per, self._sender_index, hit)
            self._static_agent_counts[name] = per.astype(np.int32)
        p = self.energy_params
        bits = p.model_bits
        if self.codec is not None:
            bits = self.codec.price_bits(bits)
        self._priced_bits = float(bits)
        self._on_device = {}            # (name, device) -> tensor

    def _const(self, name, value: np.ndarray, device) -> torch.Tensor:
        key = (name, str(torch.device(device)))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(value, device=device)
        return self._on_device[key]

    @property
    def width(self) -> int:
        """Columns of one packed row (:meth:`pack`)."""
        return len(_SCALAR_FIELDS) + len(_AGENT_FIELDS) * self.topology.K

    # -- device (once per round) -----------------------------------------

    def _per_agent(self, hit):
        """(K,) int32 per-SENDER count of the True positions of ``hit``
        (plan-shaped bool): a sum over receivers on the dense plan, an
        ``index_add_`` over the lane or slot senders on the others."""
        if self._sender_index is None:
            return hit.sum(dim=0, dtype=torch.int32)
        idx = self._const("senders", self._sender_index, hit.device)
        out = torch.zeros((self.topology.K,), dtype=torch.int32,
                          device=hit.device)
        return out.index_add_(0, idx.reshape(-1),
                              hit.reshape(-1).to(torch.int32))

    def row(self, stacked, survival, *, metric, reached, live,
            active=None, age=None):
        """One round's row, tensors on the params' device (on a meshed
        engine ``stacked`` is this rank's rows, and the disagreement comes
        from :func:`mesh_disagreement`: every other field reads only the
        round's draws, which every rank holds whole). ``survival``
        is the PLAN-SHAPED surviving-edge tensor the round's mixing
        ACTUALLY used: ``engine.round_survival`` lanes, or on async rounds
        ``AsyncRound.delivered`` (the wires actually shipped — Eq. (11)
        bills nothing a sleeping agent did not send), with ``active=`` the
        (K,) activity and ``age=`` the plan-shaped wire ages. ``None`` on
        static graphs, where the counts are the topology's. Lockstep
        rounds leave ``active``/``age`` None and report full
        participation (``n_active = K, max_age = 0``)."""
        device = next(iter(stacked.values())).device
        i32 = torch.int32
        if survival is None:
            counts = {k: _scalar(self._static_counts[k], i32, device)
                      for k, _ in _CLASSES}
            agents = {k: self._const(f"static_{k}",
                                     self._static_agent_counts[k], device)
                      for k, _ in _CLASSES}
        else:
            counts, agents = {}, {}
            for k, _ in _CLASSES:
                hit = survival & self._const(f"mask_{k}",
                                             self._class_masks[k], device)
                counts[k] = hit.sum(dtype=i32)
                agents[k] = self._per_agent(hit)
        n_active = (_scalar(self.topology.K, i32, device) if active is None
                    else active.sum(dtype=i32))
        if age is None or age.numel() == 0:     # lockstep, or no lane
            max_age = _scalar(0, i32, device)
        else:
            real = self._const("real", self._real_mask, device)
            max_age = torch.where(real, age.to(i32),
                                  torch.zeros((), dtype=i32,
                                              device=device)).max()
        return {
            "live": _scalar(live, torch.bool, device),
            "reached": _scalar(reached, torch.bool, device),
            "metric": _scalar(metric, torch.float32, device),
            "disagreement": (
                consensus_disagreement(stacked)
                if self.engine.local_rows is None
                else mesh_disagreement(stacked, self.engine)),
            "n_sl": counts["SL"], "n_ul": counts["UL"], "n_dl": counts["DL"],
            "n_active": n_active, "max_age": max_age,
            "agent_sl": agents["SL"], "agent_ul": agents["UL"],
            "agent_dl": agents["DL"],
        }

    def frozen_row(self, device="cpu"):
        """The row of a round computed after the hit and discarded:
        all-zero, ``live`` off — pricing and ledgers skip it."""
        z = {name: torch.zeros((), dtype=torch.int32, device=device)
             for name in _SCALAR_FIELDS}
        z["live"] = torch.zeros((), dtype=torch.bool, device=device)
        z["reached"] = torch.zeros((), dtype=torch.bool, device=device)
        z["metric"] = torch.zeros((), dtype=torch.float32, device=device)
        z["disagreement"] = torch.zeros((), dtype=torch.float32,
                                        device=device)
        for name in _AGENT_FIELDS:
            z[name] = torch.zeros((self.topology.K,), dtype=torch.int32,
                                  device=device)
        return z

    def live_row(self, live, row):
        """``row`` where the 0-d bool ``live`` holds, else
        :meth:`frozen_row`, field by field (how the drivers discard the
        row of a round computed after the hit)."""
        frozen = self.frozen_row(live.device)
        return {k: torch.where(live, v, frozen[k]) for k, v in row.items()}

    def pack(self, rows):
        """Rows → one (R, :attr:`width`) float64 tensor on their device,
        ready to ride a chunk's single device→host copy. float64 holds
        every f32 metric and int32 count exactly."""
        f64 = torch.float64
        return torch.stack([
            torch.cat([torch.stack([r[k].to(f64) for k in _SCALAR_FIELDS])]
                      + [r[k].to(f64) for k in _AGENT_FIELDS])
            for r in rows])

    def unpack(self, packed) -> dict:
        """The host side of :meth:`pack`: a (R, :attr:`width`) array →
        stacked row fields as numpy arrays of their own dtypes."""
        a = np.asarray(packed)
        n = len(_SCALAR_FIELDS)
        out = {k: a[:, i] for i, k in enumerate(_SCALAR_FIELDS)}
        for k in ("live", "reached"):
            out[k] = out[k] != 0
        for k in ("metric", "disagreement"):
            out[k] = out[k].astype(np.float32)
        for k in ("n_sl", "n_ul", "n_dl", "n_active", "max_age"):
            out[k] = out[k].astype(np.int64)
        K = self.topology.K
        for j, k in enumerate(_AGENT_FIELDS):
            out[k] = a[:, n + j * K:n + (j + 1) * K].astype(np.int64)
        return out

    # -- host (once per chunk, after the read) ---------------------------

    def price(self, n_sl: int, n_ul: int, n_dl: int) -> dict:
        """Eq.-(11) joules of one round from its surviving per-class
        counts — float64, written as the SAME Python expression
        ``Topology.round_comm_joules`` evaluates (float addition is not
        associative; matching the expression keeps the stream's sum
        bitwise equal to the post-hoc replay)."""
        p = self.energy_params
        bits = self._priced_bits
        sl_cost = energy.sidelink_cost_per_bit(p)
        return {
            "wire_bits": bits * (n_sl + n_ul + n_dl),
            "joules_sl": bits * (n_sl * sl_cost),
            "joules_ul": bits * (n_ul / p.E_UL),
            "joules_dl": bits * (n_dl / p.E_DL),
            "joules": bits * (n_sl * sl_cost
                              + n_ul / p.E_UL + n_dl / p.E_DL),
        }

    def price_agents(self, agent_sl, agent_ul, agent_dl) -> list:
        """Per-agent Eq.-(11) joules from the per-SENDER counts — the
        same literal expression as :meth:`price` per agent, so an agent
        with zero surviving sends bills exactly ``0.0`` (a sleeping agent
        transmits nothing and pays nothing)."""
        p = self.energy_params
        bits = self._priced_bits
        sl_cost = energy.sidelink_cost_per_bit(p)
        return [bits * (int(a_sl) * sl_cost
                        + int(a_ul) / p.E_UL + int(a_dl) / p.E_DL)
                for a_sl, a_ul, a_dl in zip(agent_sl, agent_ul, agent_dl)]

    def finalize(self, rows, start: int, driver: str = "fl",
                 extra: Optional[dict] = None):
        """Stacked chunk rows (tensors or numpy, leading axis = rounds)
        → list of host event dicts, one per round, priced in float64."""
        host = {k: _host(v) for k, v in rows.items()}
        n = host["live"].shape[0]
        base = {"type": "round", "driver": driver,
                "plan": self.engine.plan.kind,
                "topology": self.topology.name, "K": int(self.topology.K)}
        if extra:
            base.update(extra)
        events = []
        for i in range(n):
            e = dict(base)
            e["round"] = int(start) + i
            e["live"] = bool(host["live"][i])
            e["reached"] = bool(host["reached"][i])
            e["metric"] = float(host["metric"][i])
            e["disagreement"] = float(host["disagreement"][i])
            n_sl = int(host["n_sl"][i])
            n_ul = int(host["n_ul"][i])
            n_dl = int(host["n_dl"][i])
            e.update(n_sl=n_sl, n_ul=n_ul, n_dl=n_dl,
                     edges=n_sl + n_ul + n_dl,
                     n_active=int(host["n_active"][i]),
                     max_age=int(host["max_age"][i]))
            e.update(self.price(n_sl, n_ul, n_dl))
            a_sl = [int(v) for v in host["agent_sl"][i]]
            a_ul = [int(v) for v in host["agent_ul"][i]]
            a_dl = [int(v) for v in host["agent_dl"][i]]
            e.update(agent_sl=a_sl, agent_ul=a_ul, agent_dl=a_dl,
                     agent_joules=self.price_agents(a_sl, a_ul, a_dl))
            events.append(e)
        return events

    def collect(self, rows) -> dict:
        """A list of device rows → their stacked host fields, in ONE
        device→host copy (``scanloop.to_host``)."""
        return self.unpack(scanloop.to_host(self.pack(rows)))

    def event(self, t: int, row, driver: str = "fl",
              extra: Optional[dict] = None) -> dict:
        """One round's event, read from the device in one copy (the
        streaming path). ``row`` is a row dict or its packed (:attr:`width`,)
        tensor."""
        fields = (self.unpack(scanloop.to_host(row[None]))
                  if isinstance(row, torch.Tensor) else self.collect([row]))
        return self.finalize(fields, start=int(t), driver=driver,
                             extra=extra)[0]


class MetricBuffer:
    """Host-side ring buffer of finalized round events. ``capacity``
    bounds retention (oldest rounds dropped first); ``None`` keeps
    everything — the default, since one event is a few hundred bytes."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = capacity
        self._events = collections.deque(maxlen=capacity)
        self.dropped = 0            # rounds evicted by the ring

    def append(self, event: dict):
        if (self.capacity is not None
                and len(self._events) == self.capacity):
            self.dropped += 1
        self._events.append(event)

    def extend(self, events):
        for e in events:
            self.append(e)

    def rows(self, live_only: bool = True):
        """Events in round order; ``live_only`` drops the frozen rounds
        (the default — they carry no information)."""
        if live_only:
            return [e for e in self._events if e.get("live", True)]
        return list(self._events)

    def __len__(self):
        return len(self._events)

    def clear(self):
        self._events.clear()
        self.dropped = 0
