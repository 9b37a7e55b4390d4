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
reads the chunk's flags once to recover t_i with ``first_hit``.

Run:  PYTHONPATH=src python -m repro_torch.rl.casestudy --t0 60
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional

import torch
from torch.func import grad, vmap

import repro_torch
from repro_torch.comms import codecs
from repro_torch.configs import get_arch
from repro_torch.core import energy, maml, scanloop
from repro_torch.core.engine import ConsensusEngine
from repro_torch.core.multitask import ClusterNetwork
from repro_torch.core.protocol import ProtocolResult
from repro_torch.models import dqn as qmodel
from repro_torch.rl import dqn as dqnrl
from repro_torch.rl import gridworld as gw

META_TASKS = (0, 1, 5)        # {τ1, τ2, τ6} of Fig. 2(c)
R_TARGET = 100.0              # running-reward target (rescaled units)


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


def _where(flag, new, old):
    return {k: torch.where(flag, new[k], old[k]) for k in new}


@dataclass
class CaseStudy:
    """Driver of the Fig. 3 experiment (lockstep, static cluster graph)."""

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
    #: consensus plan of the per-cluster engine ("auto", "dense",
    #: "sparse", or the JAX names "dense-xla" / "sparse-pallas")
    plan: str = "auto"
    #: rounds between host syncs of the reached flags / meta losses
    chunk: int = 8
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
        self.engine = ConsensusEngine(self.cluster_topology, codec=self.codec,
                                      plan=self.plan)

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
        """Stage 1: t0 meta rounds, losses synced once per chunk."""
        params = self.init_params(generator)
        hist, pending = [], []
        for t in range(t0):
            params, m = self.meta_round(params, generator)
            pending.append(m["meta_loss"])
            if len(pending) == self.chunk or t == t0 - 1:
                hist.extend(torch.stack(pending).tolist())
                pending = []
        return params, hist

    # -- stage 2 -----------------------------------------------------------------
    def fl_round(self, task_id, stacked, codec_state, generator):
        """Local clipped SGD on every robot, one consensus round, and the
        greedy running reward of robot 0. Returns (params, state, R)."""
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
        new, codec_state = self.engine.step(
            new, codec_state, None if self.codec is None else generator)
        R = dqnrl.evaluate(generator, {k: v[0] for k, v in new.items()},
                           self.cfg, task_id, episodes=4)
        return new, codec_state, R

    def adapt_task(self, generator, task_id: int, init_params, *,
                   max_rounds: int = 400):
        """Decentralized FL adaptation of one task; returns (params, t_i,
        reward history). Bills ``self.last_adapt_comm_joules``."""
        C = self.network.devices_per_cluster
        stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
                   for k, v in init_params.items()}
        codec_state = self.engine.init_state(stacked)
        reached = torch.zeros((), dtype=torch.bool, device=self.device)
        hist, rounds = [], max_rounds
        for start in range(0, max_rounds, self.chunk):
            hits, Rs = [], []
            for _t in range(start, min(start + self.chunk, max_rounds)):
                new, new_state, R = self.fl_round(task_id, stacked,
                                                  codec_state, generator)
                live = ~reached
                stacked = _where(live, new, stacked)
                if new_state is not None:
                    codec_state = _where(live, new_state, codec_state)
                hit = live & (R >= self.r_target)
                reached = reached | hit
                hits.append(hit)
                Rs.append(torch.where(live, R, torch.nan))
            hits = torch.stack(hits).cpu().numpy()          # one sync
            hist.extend(r for r in torch.stack(Rs).tolist() if r == r)
            h = scanloop.first_hit(hits)
            if h is not None:
                rounds = start + h + 1
                break
        # Eq.-(11) bill over exactly the rounds used (static graph)
        self.last_adapt_comm_joules = rounds * float(
            self.cluster_topology.round_comm_joules(
                self.energy_params, codec=self.codec))
        return stacked, rounds, hist

    def run(self, generator, t0: int, *, max_rounds: int = 400
            ) -> ProtocolResult:
        meta_params, meta_hist = self.meta_train(generator, t0)
        rounds, hists = [], []
        for tid in range(self.network.num_tasks):
            _, t_i, h = self.adapt_task(generator, tid, meta_params,
                                        max_rounds=max_rounds)
            rounds.append(t_i)
            hists.append(h)
        return ProtocolResult(
            t0=t0, rounds_per_task=rounds, meta_history=meta_hist,
            fl_histories=hists, energy_params=self.energy_params,
            Q=self.network.Q, cluster_topology=self.cluster_topology,
            codec=self.codec)


def run_case_study(seed: int = 0, *, t0: int = 210, max_rounds: int = 400,
                   codec=None, plan: str = "auto", device: str = "cuda",
                   **kw) -> ProtocolResult:
    """One Monte-Carlo run of the Fig. 3 experiment (optionally with a
    compressed, codec-priced sidelink exchange) on ``plan``."""
    cs = CaseStudy(codec=codec, plan=plan, device=device, **kw)
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    kw = dict(max_rounds=args.max_rounds, codec=args.codec, plan=args.plan,
              device=args.device, inner_steps=10, outer_lr=0.01)
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
