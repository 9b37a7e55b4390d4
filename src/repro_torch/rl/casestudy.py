"""The paper's Sect. IV case study, end to end:

* M = 6 trajectory tasks, 2-robot clusters (ClusterNetwork);
* MAML meta-training on Q = 3 tasks {τ1, τ2, τ6} (Fig. 2(c));
* per-cluster decentralized FL (Eq. 6) adaptation, measuring t_i = rounds
  to reach the running-reward target;
* the Eq. (8)–(12) energy bill with the paper-calibrated constants.

Each robot gathers one 20-motion ε-greedy episode per round with its own
current Q-network and takes B_i = 20 clipped local SGD steps on it; the
cluster then runs one consensus round through its engine.

Rounds run in a host loop that syncs once per ``chunk`` rounds: each
round's reached flag stays on the device, a round after the hit leaves
params and codec state frozen (``torch.where`` on the flag), and the host
reads the chunk's flags once to recover t_i with ``first_hit``. Each
round is one replay of a round program held by the instance (the meta
round, and one FL round per task: on the card each is captured once as a
CUDA graph and replayed with one host call a round).

Links may fade each round (``dropout_p``) and robots may sleep
(``availability``, ``tau``, ``staleness_decay``): each task's engine then
draws a whole chunk's link survival and robot availability in one
vectorised call on the device, a sleeping robot skips local SGD and
neither mixes nor updates its residuals, and Eq. (11) bills only the
wires delivered, by replaying the same draws on the host over exactly the
rounds used.

With ``telemetry`` (:class:`repro_torch.telemetry.Telemetry`) each meta
round lands as a ``maml`` event and each FL round as an ``fl`` event
tagged ``task_id``; the rows ride the chunk's one read, and under dropout
``telemetry.joules(task_id=i)`` equals the post-hoc bill exactly.

Run:  PYTHONPATH=src python -m repro_torch.rl.casestudy --t0 60
"""
from __future__ import annotations

import argparse
import weakref
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch.func import grad, vmap

import repro_torch
from repro_torch.comms import codecs
from repro_torch.configs import get_arch
from repro_torch.core import energy, federated, maml
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine, where_active
from repro_torch.core.multitask import ClusterNetwork
from repro_torch.core.protocol import ProtocolResult, stage_generators
from repro_torch.models import dqn as qmodel
from repro_torch.rl import dqn as dqnrl
from repro_torch.rl import gridworld as gw

META_TASKS = (0, 1, 5)        # {τ1, τ2, τ6} of Fig. 2(c)
R_TARGET = 100.0              # running-reward target (rescaled units)


def behaviour_rollout(generator, task_id: int, *, steps: int = 20,
                      batch: int = 8, device="cuda"):
    """Random-walk behaviour policy (ε = 1), task-dependent rewards only:
    ``batch`` episodes of ``steps`` motions from the common entry point,
    flattened to (steps · batch, ...) transitions, step-major."""
    pos = torch.as_tensor(gw.ENTRY, device=device).long().expand(batch, 2)
    out = {"state": [], "action": [], "reward": [], "next_state": []}
    for _ in range(steps):
        a = torch.randint(0, gw.NUM_ACTIONS, (batch,), generator=generator,
                          device=device)
        s = gw.one_hot_state(pos)
        pos, r = gw.step(pos, a, task_id)
        for name, v in zip(out, (s, a, r, gw.one_hot_state(pos))):
            out[name].append(v)
    return {"state": torch.stack(out["state"]).reshape(-1, gw.NUM_CELLS),
            "action": torch.stack(out["action"]).reshape(-1),
            "reward": torch.stack(out["reward"]).reshape(-1),
            "next_state": torch.stack(out["next_state"]).reshape(
                -1, gw.NUM_CELLS)}


def sample_td_batches(generator, task_id: int, n_batches: int, *,
                      batch_size: int = 64, episodes: int = 16,
                      device="cuda"):
    """(n_batches, batch_size, ...) TD transitions resampled from
    :func:`behaviour_rollout`."""
    data = behaviour_rollout(generator, task_id, batch=episodes,
                             device=device)
    N = data["state"].shape[0]
    idx = torch.randint(0, N, (n_batches, batch_size), generator=generator,
                        device=device)
    return {k: v[idx] for k, v in data.items()}


def sample_episode_batches(generator, params, cfg, task_id: int,
                           n_batches: int, *, batch_size: int = 16,
                           epsilon: float = 0.1, episodes: int = 1):
    """The paper's per-round data: ``episodes`` ε-greedy 20-motion
    episodes collected with the CURRENT Q-network, resampled into
    (n_batches, batch_size, ...) minibatches."""
    device = next(iter(params.values())).device
    data = gw.rollout(generator, lambda s: qmodel.forward(params, cfg, s),
                      task_id, steps=20, epsilon=epsilon, batch=episodes,
                      device=device)
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items()}
    N = flat["state"].shape[0]
    idx = torch.randint(0, N, (n_batches, batch_size), generator=generator,
                        device=device)
    return {k: v[idx] for k, v in flat.items()}


def _clipped_sgd_steps(loss_fn, params, batches, lr: float,
                       clip: float = 5.0):
    """SGD steps with the update's global norm clipped to ``clip``."""
    for i in range(batches["state"].shape[0]):
        b = {k: v[i] for k, v in batches.items()}
        g = grad(loss_fn)(params, b)
        gn = torch.sqrt(sum(x.square().sum() for x in g.values()))
        scale = torch.clamp(clip / torch.clamp_min(gn, 1e-9), max=1.0)
        params = {k: w - lr * scale * g[k] for k, w in params.items()}
    return params


def delivered_comm_joules(base, masks, energy_params, codec=None) -> float:
    """Eq.-(11) joules of the wires in ``masks`` (per round a (K, K) bool:
    receiver k got sender h's wire), each priced at its link class in
    ``base``, summed round by round from 0.0 in float64."""
    total = 0.0
    for m in masks:
        m = np.asarray(m, bool)
        billed = topo_lib.Topology(
            f"{base.name}~billed", m,
            np.where(m, np.asarray(base.link_class), topo_lib.NONE))
        total += billed.round_comm_joules(energy_params, codec=codec)
    return float(total)


@dataclass
class CaseStudy:
    """Driver of the Fig. 3 experiment."""

    cfg: object = None
    inner_lr: float = 0.01
    outer_lr: float = 0.005
    fl_lr: float = 0.01
    inner_steps: int = 5
    fl_local_steps: int = 20       # B_i of Table I
    epsilon: float = 0.1           # Sect. IV-A exploration
    first_order: bool = True
    r_target: float = R_TARGET
    energy_params: object = None
    #: exchange codec spec (e.g. "int8"): cluster messages are sent AND
    #: Eq.-(11)-priced in this wire format (error feedback on lossy ones)
    codec: object = None
    #: per-round link-failure probability: each task's engine carries a
    #: ``GraphProcess.dropout`` seeded at ``dropout_seed + task_id``, and
    #: Eq. (11) bills the links that survived
    dropout_p: float = 0.0
    dropout_seed: int = 0
    #: optional ``AgentProcess``: per-round robot availability; each
    #: task's engine runs async with the process reseeded at
    #: ``seed + task_id``, and Eq. (11) bills delivered wires only
    availability: object = None
    #: hard staleness bound τ in rounds (async only; None = ∞)
    tau: object = None
    #: λ ∈ (0, 1]: stale lanes mix at λ^age (1.0 = lockstep-exact)
    staleness_decay: float = 1.0
    #: consensus plan of the per-cluster engine ("auto", "dense",
    #: "sparse", or the JAX names "dense-xla" / "sparse-pallas")
    plan: str = "auto"
    #: rounds between host syncs of the reached flags / meta losses
    chunk: int = 8
    #: optional :class:`repro_torch.telemetry.Telemetry`: meta rounds land
    #: as ``maml`` events, every task's FL rounds as ``fl`` events tagged
    #: ``task_id`` (``metric`` = the running reward R, ``reached`` = the
    #: hit, disagreement on the mixed params), priced with this case
    #: study's ``energy_params`` so ``telemetry.joules(task_id=i)`` equals
    #: the post-hoc ``last_adapt_comm_joules`` under dropout. t0, t_i,
    #: histories and params are bit-identical with telemetry off.
    telemetry: object = None
    device: str = "cuda"

    def __post_init__(self):
        repro_torch.set_f32_matmul()
        self.cfg = self.cfg or get_arch("paper-dqn")
        self.chunk = max(int(self.chunk), 1)
        self.energy_params = (self.energy_params
                              or energy.paper_calibrated("fig3"))
        self.codec = codecs.resolve_codec(self.codec)
        self.network = ClusterNetwork(num_tasks=gw.NUM_TASKS,
                                      devices_per_cluster=2,
                                      meta_task_ids=META_TASKS)
        # one cluster's graph: the Eq.-(6) mixing AND the Eq.-(11) pricing
        self.cluster_topology = self.network.cluster_topology()
        self._engines = {
            tid: ConsensusEngine(
                self.cluster_topology, codec=self.codec, plan=self.plan,
                graph=(topo_lib.GraphProcess.dropout(
                    self.dropout_p, seed=self.dropout_seed + tid)
                    if self.dropout_p > 0 else None),
                agents=self._agent_process(tid), tau=self.tau,
                staleness_decay=self.staleness_decay)
            for tid in range(gw.NUM_TASKS)}
        self.engine = self._engines[0]
        self.fl_delivered = {}
        self.fl_params = {}
        self.fl_codec_state = {}
        self.fl_async_state = {}
        # the round programs, built on first use and held per instance
        self._meta_program = None
        self._fl_programs = {}
        if self.telemetry is not None:
            # recorders carry THIS case study's billing constants so the
            # stream reconciles exactly with the post-hoc replay
            for eng in self._engines.values():
                self.telemetry.recorder_for(eng, self.energy_params)

    def _agent_process(self, task_id):
        """The availability process of one task: ``self.availability``
        reseeded at ``seed + task_id`` (independent sleep draws per task,
        replayable on the host)."""
        if self.availability is None:
            return None
        return replace(self.availability,
                       seed=self.availability.seed + task_id)

    def _loss_fn(self, target):
        cfg = self.cfg
        return lambda p, b: dqnrl.td_loss(p, cfg, b, target_params=target)

    # -- stage 1 -----------------------------------------------------------------
    def init_params(self, generator):
        return qmodel.init(self.cfg, generator=generator, device=self.device)

    def meta_round(self, params, generator):
        """One MAML round (Eqs. 3–5) over the Q meta tasks."""
        sup, qry = [], []
        for tid in META_TASKS:
            sup.append(sample_episode_batches(
                generator, params, self.cfg, tid, self.inner_steps,
                epsilon=self.epsilon))
            q = sample_episode_batches(generator, params, self.cfg, tid, 1,
                                       epsilon=self.epsilon)
            qry.append({k: v[0] for k, v in q.items()})
        stack = lambda bs: {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
        target = {k: v.detach() for k, v in params.items()}
        return maml.maml_meta_step(
            self._loss_fn(target), params, stack(sup), stack(qry),
            inner_lr=self.inner_lr, outer_lr=self.outer_lr,
            inner_steps=self.inner_steps, first_order=self.first_order)

    def meta_train(self, generator, t0: int):
        """Stage 1: t0 meta rounds from ``init_params(generator)``, losses
        (and meta-gradient norms) synced once per chunk."""
        return self.run_meta(generator, self.init_params(generator), t0)

    def run_meta(self, generator, params, rounds: int):
        """``rounds`` meta rounds from ``params`` through this instance's
        meta-round program (captured once per instance on the card, the
        JAX package's ``_meta_chunk``). Returns (params, history)."""
        if self._meta_program is None:
            me = weakref.ref(self)       # no cycle: the graph dies with us
            self._meta_program = maml.maml_round_program(
                lambda _t, p, g, _b: me().meta_round(p, g),
                streaming=self.telemetry is not None
                and self.telemetry.streaming)
        return maml.run_meta_rounds(
            self._meta_program, params, rounds=rounds, chunk=self.chunk,
            generator=generator, telemetry=self.telemetry)

    # -- stage 2 -----------------------------------------------------------------
    def fl_round(self, task_id, stacked, codec_state, generator,
                 survival=None, active=None):
        """Local clipped SGD on every robot, one consensus round, and the
        greedy running reward of robot 0. Returns (params, state, R).
        ``survival``: the round's plan-shaped link survival or staleness
        weights; ``active``: (C,) robot availability (sleeping robots skip
        SGD and neither mix nor update their residuals)."""
        new, codec_state = self._fl_update(task_id, stacked, codec_state,
                                           generator, survival, active)
        return new, codec_state, self._fl_reward(task_id, new, generator)

    def _fl_update(self, task_id, stacked, codec_state, generator,
                   survival=None, active=None):
        """:meth:`fl_round` up to the mixed params and codec state."""
        C = self.network.devices_per_cluster
        agents = [{k: v[c] for k, v in stacked.items()} for c in range(C)]
        batches = [sample_episode_batches(
            generator, p, self.cfg, task_id, self.fl_local_steps,
            epsilon=self.epsilon) for p in agents]
        stacked_b = {k: torch.stack([b[k] for b in batches])
                     for k in batches[0]}
        loss_fn = self._loss_fn(agents[0])
        new = vmap(lambda p, b: _clipped_sgd_steps(loss_fn, p, b, self.fl_lr))(
            stacked, stacked_b)
        if active is not None:
            new = where_active(active, new, stacked)
        engine = self._engines[task_id]
        mixed, new_state = engine.step(
            new, codec_state, None if self.codec is None else generator,
            survival=survival)
        if active is not None:
            mixed = where_active(active, mixed, new)
            if new_state is not None:
                old = (codec_state if codec_state is not None
                       else engine.init_state(new))
                new_state = where_active(active, new_state, old)
        return mixed, new_state

    def _fl_reward(self, task_id, stacked, generator):
        """The greedy running reward R of robot 0 (the round's target)."""
        return dqnrl.evaluate(generator, {k: v[0] for k, v in stacked.items()},
                              self.cfg, task_id, episodes=4)

    def _fl_program(self, task_id):
        """Task ``task_id``'s FL-round program, built once per instance
        (the JAX package's ``_fl_chunks[tid]``): its round closes over this
        instance and takes the generator as an argument, so every
        adaptation of the task replays one captured graph. The round holds
        the instance weakly, so its graph and memory go when the instance
        does, not at the next garbage collection."""
        prog = self._fl_programs.get(task_id)
        if prog is None:
            me = weakref.ref(self)

            def update(_t, p, codec_state, survival, active, generator,
                       _batches):
                return me()._fl_update(task_id, p, codec_state, generator,
                                       survival, active)

            def evaluate(new, generator):
                R = me()._fl_reward(task_id, new, generator)
                return R >= me().r_target, R

            tel = self.telemetry
            prog = federated.fl_round_program(
                self._engines[task_id], update, evaluate,
                recorder=(tel.recorder_for(self._engines[task_id])
                          if tel is not None else None),
                keep_delivered=True,
                streaming=tel is not None and tel.streaming)
            self._fl_programs[task_id] = prog
        return prog

    def adapt_task(self, generator, task_id: int, init_params, *,
                   max_rounds: int = 400):
        """Decentralized FL adaptation of one task; returns (params, t_i,
        reward history). Bills ``self.last_adapt_comm_joules`` over
        exactly the rounds used; on fading links or sleeping robots
        ``self.fl_delivered[task_id]`` keeps the wires the device
        delivered in those rounds ((t_i,) + the plan's lane shape),
        ``self.fl_params[task_id]`` the adapted params, and
        ``self.fl_codec_state[task_id]`` / ``self.fl_async_state[task_id]``
        the final codec state and ``AsyncState`` (None where there is
        none)."""
        C = self.network.devices_per_cluster
        eng = self._engines[task_id]
        stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
                   for k, v in init_params.items()}
        dynamic = eng.agents is not None or self.dropout_p > 0
        stacked, codec_state, rounds, hist, delivered, ast = \
            federated.run_chunked_rounds(
                eng, self._fl_program(task_id), stacked,
                max_rounds=max_rounds, chunk=self.chunk, generator=generator,
                telemetry=self.telemetry, telemetry_extra={"task_id": task_id},
                keep_delivered=True)
        # Eq.-(11) bill over exactly the rounds used: static lockstep runs
        # price rounds × the full graph; fading or sleeping runs replay the
        # host streams (bit-identical to the device's draws) and price
        # each round's delivered wires only: a wire bills iff its link
        # survived AND both robots were awake
        base = self.cluster_topology
        proc = self._agent_process(task_id)
        if dynamic:
            self.fl_delivered[task_id] = delivered
            drops = (topo_lib.dropout(base, self.dropout_p,
                                      seed=self.dropout_seed + task_id,
                                      rounds=rounds)
                     if self.dropout_p > 0 else [base] * rounds)
            acts = topo_lib.availability_stream(proc, base.K, rounds)
            self.last_adapt_comm_joules = delivered_comm_joules(
                base, [t_r.adjacency & a[:, None] & a[None, :]
                       for t_r, a in zip(drops, acts)],
                self.energy_params, self.codec)
        else:
            self.last_adapt_comm_joules = rounds * float(
                base.round_comm_joules(self.energy_params, codec=self.codec))
        self.fl_params[task_id] = stacked
        self.fl_codec_state[task_id] = codec_state
        self.fl_async_state[task_id] = ast
        return stacked, rounds, hist

    def run(self, generator, t0: int, *, max_rounds: int = 400
            ) -> ProtocolResult:
        """Stage 1, then every task's adaptation from the meta params.
        ``generator`` is split up front (:func:`stage_generators`) into one
        generator for meta-training and one per task, as the JAX package
        splits its key, so every task's t_i, history and params are the
        same bits at every ``chunk``."""
        gmeta, *gtasks = stage_generators(generator,
                                          1 + self.network.num_tasks)
        meta_params, meta_hist = self.meta_train(gmeta, t0)
        rounds, hists, comm = [], [], []
        for tid, g in enumerate(gtasks):
            _, t_i, h = self.adapt_task(g, tid, meta_params,
                                        max_rounds=max_rounds)
            rounds.append(t_i)
            hists.append(h)
            comm.append(self.last_adapt_comm_joules)
        # as in the JAX package, the measured joules replace the modelled
        # term only when links fade (dropout_p > 0): an availability-only
        # run bills E_total on the full graph
        return ProtocolResult(
            t0=t0, rounds_per_task=rounds, meta_history=meta_hist,
            fl_histories=hists, energy_params=self.energy_params,
            Q=self.network.Q, cluster_topology=self.cluster_topology,
            codec=self.codec,
            fl_comm_joules_measured=comm if self.dropout_p > 0 else None)


def run_case_study(seed: int = 0, *, t0: int = 210, max_rounds: int = 400,
                   codec=None, dropout_p: float = 0.0, plan: str = "auto",
                   device: str = "cuda", **kw) -> ProtocolResult:
    """One Monte-Carlo run of the Fig. 3 experiment (optionally with a
    compressed, codec-priced sidelink exchange and/or links that fail
    with probability ``dropout_p`` each round) on ``plan``."""
    cs = CaseStudy(codec=codec, dropout_p=dropout_p, plan=plan,
                   device=device, **kw)
    generator = torch.Generator(device=device).manual_seed(seed)
    return cs.run(generator, t0, max_rounds=max_rounds)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--t0", type=int, default=60,
                    help="MAML rounds (the paper's Fig. 3 uses 210)")
    ap.add_argument("--max-rounds", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default="auto",
                    help="consensus plan: auto | dense | sparse "
                         "(or dense-xla | sparse-pallas)")
    ap.add_argument("--codec", default=None,
                    help="exchange codec, e.g. int8, int4, int8:b64, bf16")
    ap.add_argument("--dropout-p", type=float, default=0.0,
                    help="per-round link-failure probability in [0, 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    kw = dict(max_rounds=args.max_rounds, codec=args.codec, plan=args.plan,
              dropout_p=args.dropout_p, device=args.device, inner_steps=10,
              outer_lr=0.01)
    print(f"== stage 1: MAML meta-training, t0={args.t0}, Q=3 tasks "
          f"{META_TASKS} ==")
    res = run_case_study(args.seed, t0=args.t0, **kw)
    s = res.summary()
    print(f"t_i per task: {res.rounds_per_task}")
    print(f"E_ML = {s['E_ML_kJ']:.1f} kJ;  E_FL per task = "
          f"{[round(e, 2) for e in s['E_FL_kJ']]} kJ")
    print(f"TOTAL (MAML, t0={args.t0}) = {s['E_total_kJ']:.1f} kJ")

    print("\n== baseline: no inductive transfer (t0 = 0) ==")
    res0 = run_case_study(args.seed + 1, t0=0, **kw)
    s0 = res0.summary()
    print(f"t_i per task: {res0.rounds_per_task}")
    print(f"TOTAL (FL only) = {s0['E_total_kJ']:.1f} kJ")
    print(f"\nenergy reduction: {s0['E_total_kJ'] / s['E_total_kJ']:.2f}x")


if __name__ == "__main__":
    main()
