"""Fig. 4 (and Fig. 3, its t0=210/t0=0 slice) on the port: impact of MAML
rounds t0 on E_ML, ΣE_FL and total E, under both communication-efficiency
regimes. The port's copy of ``benchmarks/fig4_tradeoff.py``.

One meta-training trajectory per seed with parameter snapshots at every
t0 split point (42, 66, 90, 132, 210, 240), then per-task FL adaptation
from each snapshot measuring t_i. Energies from
:mod:`repro_torch.core.energy` with the paper-calibrated constants.
Results -> JSON with the reference's keys (read unchanged by
``benchmarks/table2_rounds.py`` and by :mod:`repro_torch.rl.fig3_energy`).

Generators: a seed's meta trajectory draws from one generator seeded
with the seed; each (seed, t0, task) adaptation from its own, seeded from
``numpy.random.SeedSequence([seed, t0, task_id])`` alone. So the t_i at a
given t0 are the same bits whichever grid it ran in and at every chunk,
and a long sweep can be split across runs.

Run (on the card):
    PYTHONPATH=src python -m repro_torch.rl.fig4_tradeoff --seeds 1 \\
        --plan sparse
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import energy
from repro_torch.rl.casestudy import CaseStudy

T0_GRID = (0, 42, 66, 90, 132, 210, 240)
DEFAULT_OUT = "build/results/torch_fig4.json"

# the paper's own Table II (average FL rounds t_i), for side-by-side
PAPER_TABLE_II = {
    0: [380.1, 129.6, 93.7, 211.5, 24.2, 82.4],
    42: [29.7, 56.4, 70.9, 87.0, 70.4, 57.1],
    66: [178.8, 9.9, 14.3, 104.6, 9.8, 12.4],
    90: [84.9, 8.9, 15.6, 166.2, 11.3, 19.6],
    132: [11.6, 25.5, 25.1, 44.6, 23.1, 23.8],
    210: [6.7, 29.1, 16.5, 27.7, 32.0, 17.2],
    240: [2.7, 10.8, 9.1, 40.0, 21.8, 19.6],
}


def _save_partial(rounds, t0_grid, out, run_info=None):
    """Incremental snapshot so long sweeps are restart/deadline-safe."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    done = {t0: v for t0, v in rounds.items() if v}
    if not done:
        return
    partial = {
        "rounds": {str(k): v for k, v in done.items()},
        "mean_rounds": {str(k): np.mean(v, axis=0).tolist()
                        for k, v in done.items()},
        "paper_table_ii": {str(k): v for k, v in PAPER_TABLE_II.items()},
        "energies": {},
        "partial": True,
    }
    _add_energies(partial, done.keys())
    if run_info is not None:
        partial["run"] = run_info
    with open(out, "w") as f:
        json.dump(partial, f, indent=1)


def _add_energies(result, t0s):
    mean_rounds = {int(k): v for k, v in result["mean_rounds"].items()}
    for regime, p in (("black_SL500_UL200", energy.paper_calibrated("fig4")),
                      ("red_UL500_SL200",
                       energy.swap_ul_sl(energy.paper_calibrated("fig4")))):
        en = {t0: energy.total_energy(p, t0, 3, mean_rounds[t0])
              for t0 in mean_rounds}
        nonzero = [t0 for t0 in en if t0 > 0]
        best = min(nonzero, key=lambda t: en[t]) if nonzero else None
        result["energies"][regime] = {
            "E_kJ": {str(k): v / 1e3 for k, v in en.items()},
            "optimal_t0": best,
        }


def adapt_generator(seed: int, t0: int, task_id: int, device):
    """The generator of one (seed, t0, task) adaptation: seeded from
    (seed, t0, task_id) alone."""
    s = np.random.SeedSequence([seed, t0, task_id]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s) >> 1)


def meta_trajectory(cs: CaseStudy, generator, t0_grid):
    """One meta-training trajectory of ``max(t0_grid)`` rounds through
    ``cs.run_meta`` (the instance's meta-round program), from
    ``cs.init_params(generator)``. Returns ({t0: detached clone of the
    params after t0 rounds}, meta-loss history); the losses stay on the
    card and are read once per ``cs.chunk`` rounds."""
    params = cs.init_params(generator)
    snaps = {0: {k: v.detach().clone() for k, v in params.items()}}
    history, done = [], 0
    for t0 in sorted(set(t0_grid) - {0}):
        params, h = cs.run_meta(generator, params, t0 - done)
        history.extend(h)
        done = t0
        snaps[t0] = {k: v.detach().clone() for k, v in params.items()}
    return snaps, history


def _device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def run(seeds: int = 3, max_rounds: int = 400, t0_grid=T0_GRID,
        out: str = DEFAULT_OUT, verbose=True, *, plan: str = "auto",
        device: str = "cuda", cfg=None):
    """The t0 sweep; ``plan`` is the clusters' consensus plan (``auto``
    keeps K = 2 dense; ``sparse`` runs every combine through the CUDA
    kernel), ``cfg`` the Q-network (default paper-DQN). Writes ``out``
    after every t0 (``partial: true``) and at the end; the ``run`` key
    records the device, plan, chunk, walls and the FL rounds computed
    beside those used (the chunked loop computes a hit's whole chunk)."""
    cs = CaseStudy(cfg=cfg, inner_steps=10, outer_lr=0.01, plan=plan,
                   device=device)
    M = cs.network.num_tasks
    rounds = {t0: [] for t0 in t0_grid}   # lists of per-seed [t_1..t_M]
    info = {"device": _device_name(device), "plan": cs.engine.plan.kind,
            "chunk": cs.chunk, "max_rounds": max_rounds,
            "meta_rounds": max(t0_grid), "meta_wall_s": [],
            "wall_s": {str(t0): [] for t0 in t0_grid},
            "rounds_computed": {str(t0): [] for t0 in t0_grid}}

    for seed in range(seeds):
        t_start = time.perf_counter()
        snaps, _ = meta_trajectory(
            cs, torch.Generator(device=device).manual_seed(seed), t0_grid)
        wall = time.perf_counter() - t_start
        info["meta_wall_s"].append(wall)
        if verbose:
            per = wall / max(t0_grid) * 1e3 if max(t0_grid) else 0.0
            print(f"[seed {seed}] meta-train {max(t0_grid)} rounds "
                  f"({wall:.3f} s, {per:.2f} ms a round)", flush=True)
        for t0 in t0_grid:
            t_start = time.perf_counter()
            tis = []
            for tid in range(M):
                _, t_i, _ = cs.adapt_task(
                    adapt_generator(seed, t0, tid, device), tid, snaps[t0],
                    max_rounds=max_rounds)
                tis.append(t_i)
            wall = time.perf_counter() - t_start
            computed = [min(-(-t // cs.chunk) * cs.chunk, max_rounds)
                        for t in tis]
            rounds[t0].append(tis)
            info["wall_s"][str(t0)].append(wall)
            info["rounds_computed"][str(t0)].append(computed)
            if verbose:
                print(f"[seed {seed}] t0={t0:3d}: t_i={tis} "
                      f"sum={sum(tis)}; FL rounds computed {sum(computed)} "
                      f"for {sum(tis)} used ({wall:.3f} s)", flush=True)
            _save_partial(rounds, t0_grid, out, info)

    mean_rounds = {t0: np.mean(rounds[t0], axis=0).tolist()
                   for t0 in t0_grid}

    result = {"rounds": {str(k): v for k, v in rounds.items()},
              "mean_rounds": {str(k): v for k, v in mean_rounds.items()},
              "paper_table_ii": {str(k): v
                                 for k, v in PAPER_TABLE_II.items()},
              "energies": {}}
    _add_energies(result, t0_grid)
    result["run"] = info
    if verbose:
        for regime, r in result["energies"].items():
            print(f"{regime}: optimal t0 = {r['optimal_t0']}, "
                  f"E_kJ = { {k: round(v, 1) for k, v in r['E_kJ'].items()} }",
                  flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--plan", default="auto",
                    help="consensus plan: auto | dense | sparse "
                         "(or dense-xla | sparse-pallas)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(seeds=a.seeds, max_rounds=a.max_rounds, out=a.out, plan=a.plan,
        device=a.device)


if __name__ == "__main__":
    main()
