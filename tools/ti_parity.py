"""t_i of the JAX package's case study against the port's, over N seeds.

Runs ``CaseStudy(inner_steps=10, outer_lr=0.01).run`` of each package
(the settings of ``python -m repro_torch.rl.casestudy``) at every seed and
t0, in worker processes of one thread each, and compares the two
distributions of t_i:

* Fisher's exact test on the count of adaptations capped at
  ``--max-rounds`` (capped or not, per package; per t0 and pooled);
* a two-sample permutation test on the per-run Σt_i (exact over every
  split of the runs when there are at most 10^6, else 10^5 seeded
  draws; two-sided on the difference of the means), per t0 and pooled
  over the t0 (stratified: runs are permuted within their t0, and the
  statistic is the sum over t0 of the differences of the means);

and prices Fig. 3 from each side's per-task mean t_i at t0 = 210 and 0,
with a bootstrap over seeds (10^4 seeded resamples of the seeds both t0
ran; the 2.5 / 50 / 97.5 percentiles of the ratio, and of the JAX ratio
minus the other side's). Fisher's test counts the six adaptations of one
run as independent although they share one meta-trained init; the
permutation test and the bootstrap take the run as the unit.

  PYTHONPATH=src python tools/ti_parity.py --seeds 0-7 --t0 0,42,210 \\
      --max-rounds 400 --jobs 6
  PYTHONPATH=src python tools/ti_parity.py ... --sides jax,port-same-init
      the port starts from the JAX package's init of the same seed
      (converted), so only the rollout and minibatch draws differ.

Both sides run on the CPU. Results accumulate in ``--out`` (default
``build/results/ti_parity.json``) keyed by (side, seed, t0): a run
already there is not repeated, so a cut sweep resumes. Each run stores
its ``max_rounds``, and a file whose runs were made at another cap than
``--max-rounds`` is refused, so capped counts never mix caps.
``--tables-only`` prints the tables of that file. The sides are ``jax``,
``port`` and ``port-same-init``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KW = dict(inner_steps=10, outer_lr=0.01)
BOOT_DRAWS = 10_000


def _one_thread():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = ("--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT / "src"))


def jax_init(seed: int):
    """The JAX package's init of ``CaseStudy.run(PRNGKey(seed), ...)``,
    as numpy: run splits (kmeta, kfl), meta_train splits (kinit, kdata)."""
    import jax
    from repro.rl.casestudy import CaseStudy
    kmeta, _ = jax.random.split(jax.random.PRNGKey(seed))
    kinit, _ = jax.random.split(kmeta)
    return jax.tree.map(np.asarray, CaseStudy(**KW).init_params(kinit))


def run_one(side: str, seed: int, t0: int, max_rounds: int) -> dict:
    """One whole run of one side; returns its t_i and wall seconds."""
    _one_thread()
    start = time.perf_counter()
    if side == "jax":
        import jax
        from repro.rl.casestudy import CaseStudy
        res = CaseStudy(**KW).run(jax.random.PRNGKey(seed), t0,
                                  max_rounds=max_rounds)
    else:
        import torch
        torch.set_num_threads(1)
        from repro_torch.convert import params_from_numpy
        from repro_torch.rl.casestudy import CaseStudy
        cs = CaseStudy(device="cpu", **KW)
        if side == "port-same-init":
            init = params_from_numpy(jax_init(seed), device="cpu")
            cs.init_params = lambda generator: {k: v.clone()
                                                for k, v in init.items()}
        gen = torch.Generator(device="cpu").manual_seed(seed)
        res = cs.run(gen, t0, max_rounds=max_rounds)
    return {"side": side, "seed": seed, "t0": t0, "max_rounds": max_rounds,
            "t_i": [int(t) for t in res.rounds_per_task],
            "seconds": time.perf_counter() - start}


def fisher_exact(a: int, b: int, c: int, d: int) -> float:
    """Two-sided p of Fisher's exact test on [[a, b], [c, d]] (the sum of
    the tables at most as likely as the observed one)."""
    n1, n2, k = a + b, c + d, a + c
    lo, hi = max(0, k - n2), min(k, n1)

    def p(x):
        return (math.comb(n1, x) * math.comb(n2, k - x)
                / math.comb(n1 + n2, k))

    p_obs = p(a)
    return min(1.0, sum(p(x) for x in range(lo, hi + 1)
                        if p(x) <= p_obs * (1 + 1e-9)))


def permutation_p(x, y, *, draws: int = 100_000, seed: int = 0) -> float:
    """Two-sided permutation test on mean(x) − mean(y)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    pooled = np.concatenate([x, y])
    n, nx = len(pooled), len(x)
    obs = abs(x.mean() - y.mean())
    if math.comb(n, nx) <= 1_000_000:
        splits = (np.fromiter(idx, int, nx)
                  for idx in itertools.combinations(range(n), nx))
    else:
        rng = np.random.default_rng(seed)
        splits = (rng.permutation(n)[:nx] for _ in range(draws))
    hits = total = 0
    tot = pooled.sum()
    for idx in splits:
        sx = pooled[idx].sum()
        d = abs(sx / nx - (tot - sx) / (n - nx))
        hits += d >= obs - 1e-9
        total += 1
    return hits / total


def stratified_permutation_p(strata, *, draws: int = 100_000,
                             seed: int = 0) -> float:
    """Two-sided permutation test pooled over strata: ``strata`` is a
    list of (x, y) samples; runs are permuted within their stratum and
    the statistic is Σ_strata (mean(x) − mean(y))."""
    rng = np.random.default_rng(seed)
    pooled = [np.concatenate([np.asarray(x, float), np.asarray(y, float)])
              for x, y in strata]
    sizes = [len(x) for x, _y in strata]

    def stat(perms):
        return sum(p[:nx].mean() - p[nx:].mean()
                   for p, nx in zip(perms, sizes))

    obs = abs(stat(pooled))
    hits = sum(abs(stat([rng.permutation(p) for p in pooled])) >= obs - 1e-9
               for _ in range(draws))
    return hits / draws


def summarize(runs, max_rounds: int) -> dict:
    """Per side and t0: every t_i, capped count, Σt_i mean and spread."""
    out = {}
    for r in runs:
        cell = out.setdefault(r["side"], {}).setdefault(str(r["t0"]), {
            "seeds": [], "t_i": [], "sum_t_i": []})
        cell["seeds"].append(r["seed"])
        cell["t_i"].append(r["t_i"])
        cell["sum_t_i"].append(sum(r["t_i"]))
    for side in out.values():
        for cell in side.values():
            order = np.argsort(cell["seeds"])
            for k in ("seeds", "t_i", "sum_t_i"):
                cell[k] = [cell[k][i] for i in order]
            flat = [t for ts in cell["t_i"] for t in ts]
            s = np.asarray(cell["sum_t_i"], float)
            cell.update(adaptations=len(flat),
                        capped=sum(t >= max_rounds for t in flat),
                        mean_sum_t_i=float(s.mean()),
                        std_sum_t_i=float(s.std(ddof=1)) if len(s) > 1
                        else 0.0,
                        min_sum_t_i=float(s.min()),
                        max_sum_t_i=float(s.max()))
    return out


def compare(summary: dict, other: str) -> dict:
    """The two tests of ``jax`` against ``other``, per t0 and pooled."""
    a, b = summary.get("jax", {}), summary.get(other, {})
    tests, pooled, strata = {}, [0, 0, 0, 0], []
    for t0 in sorted(set(a) & set(b), key=int):
        ca, cb = a[t0], b[t0]
        table = [ca["capped"], ca["adaptations"] - ca["capped"],
                 cb["capped"], cb["adaptations"] - cb["capped"]]
        pooled = [p + q for p, q in zip(pooled, table)]
        strata.append((ca["sum_t_i"], cb["sum_t_i"]))
        tests[t0] = {"fisher_capped_p": fisher_exact(*table),
                     "permutation_sum_t_i_p": permutation_p(
                         ca["sum_t_i"], cb["sum_t_i"]),
                     "runs": [len(ca["sum_t_i"]), len(cb["sum_t_i"])]}
    if tests:
        tests["pooled"] = {"fisher_capped_p": fisher_exact(*pooled),
                           "permutation_sum_t_i_p":
                               stratified_permutation_p(strata)}
    return tests


def fig3(summary: dict) -> dict:
    """Fig. 3 from each side's per-task mean t_i at t0 = 210 and t0 = 0
    (the seeds both ran), priced as ``repro_torch.rl.fig3_energy``
    does: E(MAML) = E_ML(210, Q = 3) + Σ E_FL(t̄_i(210)), E(no MAML) =
    Σ E_FL(t̄_i(0)), and their ratio (the paper's ≥ 2× claim)."""
    from repro_torch.core import energy
    p = energy.paper_calibrated("fig3")
    e_ml = energy.maml_energy(p, 210, 3)

    def priced(t_i_0, t_i_210):
        """(E with MAML, E without) from per-task mean t_i."""
        return (e_ml + sum(energy.fl_energy(p, t) for t in t_i_210),
                sum(energy.fl_energy(p, t) for t in t_i_0))

    out, boot = {}, {}
    for side, cells in summary.items():
        if "0" not in cells or "210" not in cells:
            continue
        seeds = sorted(set(cells["0"]["seeds"]) & set(cells["210"]["seeds"]))
        t_i = {t0: np.asarray([ts for s, ts in zip(cells[t0]["seeds"],
                                                   cells[t0]["t_i"])
                               if s in seeds], float)
               for t0 in ("0", "210")}
        total, total0 = priced(t_i["0"].mean(0), t_i["210"].mean(0))
        # bootstrap over seeds: resample the seeds, t0 = 0 and 210 alike;
        # one stream per side, as the sides' runs are independent
        rng = np.random.default_rng([0, *side.encode()])
        idx = rng.integers(0, len(seeds), size=(BOOT_DRAWS, len(seeds)))
        boot[side] = np.asarray([
            (lambda m, f: f / m)(*priced(t_i["0"][i].mean(0),
                                         t_i["210"][i].mean(0)))
            for i in idx])
        out[side] = {"seeds": seeds,
                     "mean_t_i_0": t_i["0"].mean(0).tolist(),
                     "mean_t_i_210": t_i["210"].mean(0).tolist(),
                     "total_maml_kJ": total / 1e3,
                     "total_fl_only_kJ": total0 / 1e3,
                     "reduction": total0 / total,
                     "reduction_bootstrap_2.5_50_97.5": np.percentile(
                         boot[side], [2.5, 50, 97.5]).tolist()}
    for side in out:
        if side != "jax" and "jax" in boot:
            out[side]["jax_minus_this_bootstrap_2.5_50_97.5"] = (
                np.percentile(boot["jax"] - boot[side],
                              [2.5, 50, 97.5]).tolist())
    return out


def print_tables(summary: dict, tests: dict, max_rounds: int):
    print(f"{'side':16} {'t0':>4} {'runs':>4} {'capped':>8} "
          f"{'mean Σt_i':>10} {'std':>8} {'min':>6} {'max':>6}")
    for side, cells in summary.items():
        for t0 in sorted(cells, key=int):
            c = cells[t0]
            print(f"{side:16} {t0:>4} {len(c['seeds']):>4} "
                  f"{c['capped']:>3}/{c['adaptations']:<4} "
                  f"{c['mean_sum_t_i']:>10.2f} {c['std_sum_t_i']:>8.2f} "
                  f"{c['min_sum_t_i']:>6.0f} {c['max_sum_t_i']:>6.0f}")
    for other, per in tests.items():
        for t0, t in per.items():
            line = f"jax vs {other}, t0 {t0}: Fisher (capped at " \
                   f"{max_rounds}) p = {t['fisher_capped_p']:.4g}"
            if "permutation_sum_t_i_p" in t:
                line += (f"; permutation (Σt_i) p = "
                         f"{t['permutation_sum_t_i_p']:.4g}")
            print(line)


def _range(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0-7", help="e.g. 0-7 or 0,3,5")
    ap.add_argument("--t0", default="0,42,210")
    ap.add_argument("--max-rounds", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--sides", default="jax,port",
                    help="comma list of jax, port, port-same-init")
    ap.add_argument("--out", default=str(ROOT / "build" / "results" /
                                         "ti_parity.json"))
    ap.add_argument("--tables-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))

    out = Path(args.out)
    runs = json.loads(out.read_text())["runs"] if out.exists() else []
    caps = {r.get("max_rounds") for r in runs} - {args.max_rounds}
    if caps:
        raise SystemExit(
            f"{out} holds runs made at max_rounds {sorted(caps, key=str)}, "
            f"not --max-rounds {args.max_rounds}: capped counts would mix "
            "caps; pass that cap or another --out")
    if not args.tables_only:
        sides = args.sides.split(",")
        done = {(r["side"], r["seed"], r["t0"]) for r in runs}
        todo = [(s, seed, t0) for seed in _range(args.seeds)
                for t0 in _range(args.t0) for s in sides
                if (s, seed, t0) not in done]
        print(f"{len(todo)} runs to do, {len(runs)} already in {out}",
              flush=True)
        out.parent.mkdir(parents=True, exist_ok=True)
        import multiprocessing
        with ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            futs = [pool.submit(run_one, *job, args.max_rounds)
                    for job in todo]
            for fut in as_completed(futs):
                r = fut.result()
                runs.append(r)
                print(f"{r['side']:16} seed {r['seed']} t0 {r['t0']:>3}: "
                      f"t_i {r['t_i']} Σ {sum(r['t_i'])} "
                      f"({r['seconds']:.1f} s)", flush=True)
                summary = summarize(runs, args.max_rounds)
                out.write_text(json.dumps(
                    {"max_rounds": args.max_rounds, "config": KW,
                     "runs": runs, "summary": summary}, indent=1))
    summary = summarize(runs, args.max_rounds)
    tests = {other: compare(summary, other) for other in summary
             if other != "jax"}
    energy = fig3(summary)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"max_rounds": args.max_rounds, "config": KW,
                               "runs": runs, "summary": summary,
                               "tests": tests, "fig3": energy}, indent=1))
    print_tables(summary, tests, args.max_rounds)
    for side, e in energy.items():
        lo, mid, hi = e["reduction_bootstrap_2.5_50_97.5"]
        print(f"{side}: Fig. 3 from mean t_i over seeds {e['seeds']}: "
              f"E(MAML, t0 = 210) {e['total_maml_kJ']:.2f} kJ, E(no MAML) "
              f"{e['total_fl_only_kJ']:.2f} kJ, reduction "
              f"{e['reduction']:.3f}x (bootstrap over seeds: 95 % "
              f"{lo:.3f}-{hi:.3f}, median {mid:.3f})")
        if "jax_minus_this_bootstrap_2.5_50_97.5" in e:
            lo, mid, hi = e["jax_minus_this_bootstrap_2.5_50_97.5"]
            print(f"  jax minus {side}: 95 % {lo:.3f} to {hi:.3f}, "
                  f"median {mid:.3f}")


if __name__ == "__main__":
    main()
