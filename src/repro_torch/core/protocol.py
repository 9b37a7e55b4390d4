"""The paper's two-stage MTL protocol, end to end (Fig. 1):

  stage 1 — MAML meta-optimization at the data center for t0 rounds over
            Q training tasks (Sect. II-A);
  stage 2 — per-cluster decentralized FL adaptation from the broadcast
            meta-model until each task hits its target after t_i rounds
            (Sect. II-B);

and the Eq. (8)–(12) energy bill of both (Sect. III). :class:`MTLProtocol`
is model-agnostic (any ``{name: tensor}`` params and loss); the Sect.-IV
case study (:mod:`repro_torch.rl.casestudy`) is its DQN robot instance.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import energy, federated, maml
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine
from repro_torch.core.multitask import ClusterNetwork


@dataclass
class ProtocolResult:
    t0: int
    rounds_per_task: List[int]              # t_i, i = 1..M
    meta_history: List[float]
    fl_histories: List[List[float]]
    energy_params: energy.EnergyParams
    Q: int
    cluster_topology: Optional[topo_lib.Topology] = None
    #: exchange codec (spec or Codec): prices each stage-2 sidelink
    #: message at its wire size in Eq. (11)
    codec: object = None
    #: per-task Eq.-(11) comm joules measured on the links actually up;
    #: None for static topologies, where the modeled term is exact
    fl_comm_joules_measured: Optional[List[float]] = None

    @property
    def E_FL_comm(self) -> List[float]:
        """Per-task Eq.-(11) comm term."""
        if self.fl_comm_joules_measured is not None:
            return list(self.fl_comm_joules_measured)
        return [energy.fl_comm_energy(self.energy_params, t,
                                      self.cluster_topology, self.codec)
                for t in self.rounds_per_task]

    @property
    def E_ML(self) -> float:
        return energy.maml_energy(self.energy_params, self.t0, self.Q)

    @property
    def E_FL(self) -> List[float]:
        return [energy.fl_learning_energy(self.energy_params, t,
                                          self.cluster_topology) + c
                for t, c in zip(self.rounds_per_task, self.E_FL_comm)]

    @property
    def E_total(self) -> float:
        return self.E_ML + sum(self.E_FL)

    def summary(self) -> Dict:
        from repro_torch.comms import codecs
        codec = codecs.get_codec(self.codec)
        return {
            "t0": self.t0,
            "t_i": self.rounds_per_task,
            "codec": codec.name if codec is not None else None,
            "E_ML_kJ": self.E_ML / 1e3,
            "E_FL_kJ": [e / 1e3 for e in self.E_FL],
            "E_total_kJ": self.E_total / 1e3,
        }


def stage_generators(generator, n: int):
    """``n`` independent generators on ``generator``'s device, seeded from
    one ``torch.randint`` draw of ``generator`` (read back once): the
    port's counterpart of splitting a key between the stages of a run."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s)
            for s in seeds]


def _stack(trees):
    """Stack same-structured batch pytrees along a new leading axis."""
    flat = [tree_flatten(t) for t in trees]
    spec = flat[0][1]
    return tree_unflatten([torch.stack(xs) for xs in
                           zip(*(leaves for leaves, _ in flat))], spec)


class MTLProtocol:
    """Orchestrates meta-training + task adaptation for a clustered MTL
    network.

    Arguments
    ---------
    loss_fn:        loss_fn(params, batch) -> scalar, model-agnostic.
    init_fn:        init_fn(generator) -> params (random init; its device
                    is where the protocol runs).
    network:        ClusterNetwork topology (M clusters, Q meta tasks).
    sample_support: (generator, task_id, steps) -> batch pytree with a
                    leading steps axis (inner-adaptation / local-SGD data).
    sample_query:   (generator, task_id) -> batch (meta-update data).
    target_fn:      (params, task_id) -> (reached, metric) — the paper's
                    per-task accuracy target.
    chunk:          rounds between two device→host reads in BOTH stages
                    (:func:`repro_torch.core.maml.maml_train_scan`,
                    :func:`repro_torch.core.federated.run_fl_until_scan`);
                    the meta history and every task's t_i, history and
                    params are bit-identical to ``chunk=1``.
    telemetry:      optional :class:`repro_torch.telemetry.Telemetry`
                    threaded through BOTH stages — meta rounds land as
                    ``maml`` events, every task's FL rounds as ``fl``
                    events tagged ``task_id``. Results are bit-identical
                    with telemetry off, buffered or streaming.

    :meth:`run` splits its :class:`torch.Generator` up front
    (:func:`stage_generators`) into one for meta-training (the init and
    the meta samplers) and one for each task's adaptation (its samplers
    and the codec's stochastic rounding), as the JAX package splits its
    key. A chunk that ends after a task's hit draws its discarded rounds
    from that task's generator only, so no stage depends on ``chunk``.
    """

    def __init__(self, *, loss_fn, init_fn, network: ClusterNetwork,
                 sample_support, sample_query, target_fn,
                 inner_lr=0.01, outer_lr=0.001, fl_lr=0.01,
                 inner_steps=1, fl_local_steps=20,
                 first_order=True,
                 energy_params: Optional[energy.EnergyParams] = None,
                 codec=None, chunk: int = 16, telemetry=None):
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.net = network
        self.sample_support = sample_support
        self.sample_query = sample_query
        self.target_fn = target_fn
        self.inner_lr = inner_lr
        self.outer_lr = outer_lr
        self.fl_lr = fl_lr
        self.inner_steps = inner_steps
        self.fl_local_steps = fl_local_steps
        self.first_order = first_order
        self.chunk = max(int(chunk), 1)
        self.telemetry = telemetry
        self.energy_params = energy_params or energy.paper_calibrated()
        if not first_order:
            self.energy_params = dataclasses.replace(
                self.energy_params, beta=2.0)
        # one cluster C_i's graph drives BOTH the Eq.-(6) mixing and the
        # Eq.-(11) pricing; the engine resolves the codec (error feedback
        # on lossy ones) and picks the plan for the cluster graph
        self.cluster_topology = network.cluster_topology()
        self.engine = ConsensusEngine(self.cluster_topology, codec=codec)
        self.codec = self.engine.codec
        if self.telemetry is not None:
            # pre-register with THIS protocol's billing constants so the
            # streamed ledger prices like ProtocolResult does
            self.telemetry.recorder_for(self.engine, self.energy_params)

    # -- stage 1 ------------------------------------------------------------
    def meta_train(self, generator, t0: int):
        """t0 MAML rounds over the Q meta tasks through the chunked
        driver (meta-loss history read once per ``self.chunk`` rounds).
        Returns (meta_params, history)."""
        meta_params = self.init_fn(generator)
        if t0 <= 0:
            return meta_params, []
        task_ids = list(self.net.meta_task_ids)

        def sample_tasks(g, _round):
            sup, qry = [], []
            for tid in task_ids:
                sup.append(self.sample_support(g, tid, self.inner_steps))
                qry.append(self.sample_query(g, tid))
            return _stack(sup), _stack(qry)

        return maml.maml_train_scan(
            self.loss_fn, meta_params, sample_tasks, rounds=t0,
            inner_lr=self.inner_lr, outer_lr=self.outer_lr,
            inner_steps=self.inner_steps, first_order=self.first_order,
            generator=generator, chunk=self.chunk, telemetry=self.telemetry)

    # -- stage 2 ------------------------------------------------------------
    def adapt_task(self, generator, task_id: int, init_params, *,
                   max_rounds: int = 500):
        """Decentralized FL (Eq. 6) within cluster C_i from
        ``init_params`` through the chunked driver (t_i recovered exactly
        from the per-round reached flags). Returns (params, t_i,
        history)."""
        C = self.net.devices_per_cluster
        stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
                   for k, v in init_params.items()}

        def sample_batches(g, _t):
            return _stack([self.sample_support(g, task_id,
                                               self.fl_local_steps)
                           for _ in range(C)])

        def target(stacked_params):
            p0 = {k: v[0] for k, v in stacked_params.items()}
            return self.target_fn(p0, task_id)

        return federated.run_fl_until_scan(
            self.loss_fn, stacked, sample_batches, self.engine,
            self.fl_lr, target_fn=target, max_rounds=max_rounds,
            generator=generator, chunk=self.chunk, telemetry=self.telemetry,
            telemetry_extra=({"task_id": int(task_id)}
                             if self.telemetry is not None else None))

    # -- full protocol --------------------------------------------------------
    def run(self, generator, t0: int, *, max_rounds: int = 500
            ) -> ProtocolResult:
        gmeta, *gtasks = stage_generators(generator, 1 + self.net.num_tasks)
        meta_params, meta_hist = self.meta_train(gmeta, t0)
        rounds, hists = [], []
        for task_id, g in enumerate(gtasks):
            _, t_i, hist = self.adapt_task(g, task_id, meta_params,
                                           max_rounds=max_rounds)
            rounds.append(t_i)
            hists.append(hist)
        return ProtocolResult(
            t0=t0, rounds_per_task=rounds, meta_history=meta_hist,
            fl_histories=hists, energy_params=self.energy_params,
            Q=self.net.Q, cluster_topology=self.cluster_topology,
            codec=self.codec)
