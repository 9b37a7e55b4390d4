"""Quickstart: the paper's two-stage protocol on a toy LM, end to end —
the port's twin of the JAX package's ``examples/quickstart.py``.

1. meta-train (MAML, Eqs. 3–5) a reduced stablelm-family decoder over 3
   related token tasks (``core.maml``: the tasks batched with
   ``torch.func.vmap``, so the attention kernel runs once per layer for
   all of them);
2. adapt to an UNSEEN 4th task with decentralized consensus FL (Eq. 6);
3. price both stages with the paper's energy model (Eqs. 8–12).

Run (on the card; ``--device cpu`` on the CPU, about a minute):
    PYTHONPATH=src python -m repro_torch.launch.quickstart
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core import consensus, energy, federated, maml
from repro_torch.data import TaskTokenDistribution
from repro_torch.launch.train import init_params
from repro_torch.models.api import lm_loss


def run(*, t0: int = 20, rounds: int = 8, seed: int = 0, device="cuda"):
    """Both stages and their bill. Returns a dict of the meta-loss history,
    the two adaptation loss curves (meta init, random init) and the
    energies in J."""
    cfg = reduced(get_arch("stablelm-3b"), num_layers=2, d_model=128)
    dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=4)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    n_bytes = sum(x.numel() * x.element_size() for x in params.values())
    print(f"model: {sum(x.numel() for x in params.values()):,} params")

    def loss_fn(p, batch):
        return lm_loss(p, cfg, batch["tokens"], batch["labels"])

    def batches_for(g, tasks):
        """One (4, 64) batch per entry of ``tasks``, all rolled out
        together."""
        toks, labels = dist.sample_traced(
            g, torch.as_tensor(tasks, device=device), 4, 64)
        return {"tokens": toks, "labels": labels}

    # ---- stage 1: MAML over tasks {0, 1, 2} ------------------------------
    def sample_tasks(g, _round):
        return batches_for(g, [0, 1, 2]), batches_for(g, [0, 1, 2])

    meta, hist = maml.maml_train(loss_fn, params, sample_tasks, rounds=t0,
                                 inner_lr=0.05, outer_lr=0.02, generator=gen)
    print(f"MAML {t0} rounds: meta-loss {hist[0]:.3f} -> {hist[-1]:.3f}")

    # ---- stage 2: consensus FL on unseen task 3 --------------------------
    K = 2
    mix = consensus.mixing_weights(np.ones(K), consensus.full_adjacency(K),
                                   "paper")

    def adapt(init):
        stacked = {n: x.expand((K,) + x.shape) for n, x in init.items()}
        losses = []
        for r in range(rounds):
            # the same batches for both initialisations
            g = torch.Generator(device=device).manual_seed(1000 + r)
            batches = batches_for(g, [[3] * 4] * K)
            stacked = federated.decentralized_fl_round(
                loss_fn, stacked, batches, mix, lr=0.05)
            with torch.no_grad():
                p0 = {n: x[0] for n, x in stacked.items()}
                losses.append(float(loss_fn(p0, batches_for(g, 3))))
        return losses

    from_meta = adapt(meta)
    from_rand = adapt(params)
    print(f"FL adaptation loss (unseen task): "
          f"meta-init {from_meta[0]:.3f}->{from_meta[-1]:.3f} | "
          f"random-init {from_rand[0]:.3f}->{from_rand[-1]:.3f}")

    # ---- energy accounting ------------------------------------------------
    ep = dataclasses.replace(energy.paper_calibrated("fig3"),
                             model_bits=n_bytes * 8.0)
    E_ml = energy.maml_energy(ep, t0, 3)
    E_fl = energy.fl_energy(ep, len(from_meta))
    print(f"energy: E_ML({t0} rounds) = {E_ml/1e3:.2f} kJ, "
          f"E_FL = {E_fl/1e3:.2f} kJ, total {(E_ml+E_fl)/1e3:.2f} kJ")
    return {"meta_history": hist, "from_meta": from_meta,
            "from_rand": from_rand, "E_ML": E_ml, "E_FL": E_fl}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--t0", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(t0=args.t0, rounds=args.rounds, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
