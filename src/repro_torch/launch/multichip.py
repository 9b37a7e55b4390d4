"""Mesh checks of the consensus engine's sharded and distributed plans.

Two checks, both on a MASKED round (links fading with p = 0.3, the round
the per-edge survival convention draws; a static round would miss what
masking changes):

* **mesh vs emulation** — each plan driven on a real process group (each
  process holding its own rows: a block on ``sharded``, one agent on
  ``distributed``) must agree with the same engine built without a mesh,
  which runs the whole population in one process through the same
  per-block and per-slot functions. The sharded plan must agree bit for
  bit; the distributed plan sums the same slots in the same order, and is
  held to the sparse-vs-dense gate (1e-5 plus 4 f32 ulps of the largest
  value) all the same. :func:`run_parity` spawns a gloo group of any size
  on the CPU; on one card the group is NCCL at world size 1 (NCCL takes
  one card per process, and gloo carries no CUDA all_gather or send/recv).
* **no (K, K) buffer** (the counterpart of the JAX package's HLO rule H1,
  read from device memory): one masked sharded round at K = 16384, N =
  2048 may add at most 4× the population's f32 bytes to the card's peak
  allocation (512 MiB; one (K, K) f32 buffer is 1 GiB).

The JAX harness's HLO checks (collective layout, donation, the collective
ledger) audit XLA artifacts and have no counterpart here.

Run (a gloo group on the CPU; with as many cards as ``--world``, an NCCL
group, and then the memory bound too)::

    PYTHONPATH=src python -m repro_torch.launch.multichip [--world 4]
        [--out build/results/torch_multichip.json]
"""
from __future__ import annotations

import argparse
import json
import os
import queue as queue_lib
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine
from repro_torch.launch import mesh as mesh_lib

DROPOUT_P, DROPOUT_SEED, ROUND_T = 0.3, 0, 3
H1_K, H1_N = 16384, 2048


def tolerance(x: np.ndarray) -> float:
    """The sparse-vs-dense gate: 1e-5 plus 4 f32 ulps of the largest
    value."""
    return 1e-5 + 4 * float(np.finfo(np.float32).eps) * float(
        np.abs(x).max())


def population(K: int, n: int, seed: int = 0) -> dict:
    """Two leaves of standard-normal f32 params over K agents (numpy)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, n)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def masked_engine(topo, plan, codec, *, mesh=None, num_blocks=None):
    return ConsensusEngine(
        topo, codec=codec, plan=plan, mesh=mesh, num_blocks=num_blocks,
        graph=topo_lib.GraphProcess.dropout(DROPOUT_P, DROPOUT_SEED))


def parity_case(topo, plan, codec, mesh, device) -> dict:
    """One masked round of ``plan`` on ``mesh`` against the same engine
    without a mesh, on this process's rows."""
    positions = int(mesh.size(0))
    nb = positions if plan == "sharded" else None
    on_mesh = masked_engine(topo, plan, codec, mesh=mesh, num_blocks=nb)
    alone = masked_engine(topo, plan, codec, num_blocks=nb)
    if on_mesh.local_rows is None:
        raise ValueError(
            f"{plan} on a {positions}-position mesh does not run on the "
            f"mesh for K={topo.K}: use K = {positions} (distributed) or a "
            "multiple of it (sharded)")
    pop = population(topo.K, 64)
    full = {k: torch.from_numpy(v).to(device) for k, v in pop.items()}
    mine = {k: v[on_mesh.local_rows].contiguous() for k, v in full.items()}
    got, st = on_mesh.step(mine, on_mesh.init_state(mine), t=ROUND_T)
    want, wst = alone.step(full, alone.init_state(full), t=ROUND_T)
    err, equal = 0.0, True
    pairs = [(got, want)] + ([(st, wst)] if st is not None else [])
    for a, b in pairs:
        for k in a:
            ref = b[k][on_mesh.local_rows]
            equal &= bool(torch.equal(a[k], ref))
            err = max(err, float((a[k] - ref).abs().max()))
    tol = max(tolerance(v) for v in pop.values())
    refused = None        # per-round telemetry over several positions
    if positions > 1:
        from repro_torch.telemetry import Telemetry
        try:
            on_mesh.scan_rounds(mine, rounds=1, t0=ROUND_T,
                                telemetry=Telemetry())
            refused = False
        except ValueError:
            refused = True
    return dict(plan=plan, codec=codec, K=topo.K, positions=positions,
                rows=[on_mesh.local_rows.start, on_mesh.local_rows.stop],
                bit_equal=equal, max_abs_err=err, tolerance=tol,
                telemetry_refused=refused,
                ok=(equal if plan == "sharded" else err <= tol)
                and refused is not False)


def parity_cases(world: int):
    """(topology, plan, codec) cases a ``world``-position mesh runs: the
    sharded plan over 4 agents per position, the distributed plan over
    one agent per position, each with no codec and the int8 wire."""
    def graph(K):
        if K == 1:                  # one agent, no edges
            return topo_lib.full(1)
        return (topo_lib.small_world(K, k=4, seed=1) if K >= 8
                else topo_lib.ring(K))

    return [(graph(K), plan, codec) for codec in (None, "int8")
            for K, plan in ((4 * world, "sharded"), (world, "distributed"))]


def _worker(rank, world, store, backend, cases, results):
    """One rank of :func:`run_parity`: join the group, run every case,
    report (rank, rows) or (rank, traceback)."""
    try:
        mesh_lib.init_local_group(rank, world, store, backend=backend)
        device = "cuda" if backend == "nccl" else "cpu"
        mesh = mesh_lib.make_agent_mesh(device_type=device)
        rows = [parity_case(t, p, c, mesh, device) for t, p, c in cases]
        results.put((rank, rows))
    except Exception:               # a worker boundary: report, then exit
        results.put((rank, traceback.format_exc()))
    finally:
        mesh_lib.destroy_local_group()


def run_parity(world: int, cases=None, *, backend: str = "gloo",
               timeout_s: float = 120.0) -> list:
    """Spawn ``world`` processes on this host (a gloo group through a
    file store) and run :func:`parity_case` for each case in each of
    them. Returns every rank's rows; raises if a rank failed, hung or
    disagreed with its emulation."""
    import multiprocessing as mp

    cases = parity_cases(world) if cases is None else cases
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(r, world, store, backend, cases, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                try:
                    rank, rows = results.get(timeout=max(left, 0.1))
                except queue_lib.Empty:
                    raise RuntimeError(
                        f"mesh parity: {world - len(got)} of {world} ranks "
                        f"reported nothing within {timeout_s} s") from None
                got[rank] = rows
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    bad = {r: v for r, v in got.items() if isinstance(v, str)}
    if bad:
        raise RuntimeError("mesh parity failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(bad.items())))
    rows = [dict(rank=r, **row) for r in sorted(got) for row in got[r]]
    wrong = [row for row in rows if not row["ok"]]
    if wrong:
        raise RuntimeError(f"mesh path disagrees with its emulation: {wrong}")
    return rows


def h1_memory(K: int = H1_K, n: int = H1_N, *, codec="int8",
              num_blocks: int = 4, device="cuda", seed: int = 0) -> dict:
    """Peak device memory one masked sharded round adds at K agents of n
    params, against 4× the population's f32 bytes; raises past it."""
    topo = topo_lib.ring(K)
    eng = masked_engine(topo, "sharded", codec, num_blocks=num_blocks)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = {"w": torch.randn((K, n), generator=gen, device=device)}
    st = eng.init_state(x)
    eng.step(x, st, t=ROUND_T)                 # lane tables built once
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = eng.step(x, st, t=ROUND_T)
    torch.cuda.synchronize(device)
    added = torch.cuda.max_memory_allocated(device) - base
    pop = K * n * 4
    row = dict(K=K, n_params=n, codec=codec, num_blocks=num_blocks,
               dropout_p=DROPOUT_P, added_bytes=int(added),
               bound_bytes=4 * pop, population_f32_bytes=pop,
               kk_f32_bytes=K * K * 4,
               finite=bool(torch.isfinite(out[0]["w"]).all()))
    if added > 4 * pop or not row["finite"]:
        raise RuntimeError(f"masked sharded round over its memory bound "
                           f"(or not finite): {row}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4,
                    help="processes of the group (NCCL when this host has "
                         "that many cards, else gloo on the CPU)")
    ap.add_argument("--out", default="build/results/torch_multichip.json")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    nccl = torch.cuda.device_count() >= args.world
    rows = run_parity(args.world, backend="nccl" if nccl else "gloo")
    report = {"backend": "nccl" if nccl else "gloo", "parity": rows,
              "seconds": time.perf_counter() - t0}
    if torch.cuda.is_available():
        report["h1"] = [h1_memory(codec=c) for c in (None, "int8")]
    for row in rows:
        print(f"rank {row['rank']} {row['plan']:11s} codec={row['codec']} "
              f"K={row['K']}: bit_equal={row['bit_equal']} max err "
              f"{row['max_abs_err']} (tolerance {row['tolerance']:.3g})")
    for row in report.get("h1", []):
        print(f"H1 K={row['K']} N={row['n_params']} codec={row['codec']}: "
              f"added {row['added_bytes']} B <= {row['bound_bytes']} B")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
