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

The collective ledger (the bytes each rank's round ships against the
codec's Eq.-(11) bits) is :mod:`repro_torch.analysis.costmodel`'s C1a and
C3; the JAX harness's other HLO checks (collective layout, donation)
audit XLA artifacts and have no counterpart here.

For the LM zoo, :func:`run_lm_parity` spawns a data x model gloo group
and runs :func:`lm_mesh_case` on each rank: the tensor- and data-parallel
transformer's logits, loss, gradient and one Adam step, which the tests
hold to the one-process port (tests/test_torch_sharding.py).

Run (a gloo group on the CPU; with as many cards as ``--world``, an NCCL
group, and then the memory bound too)::

    PYTHONPATH=src python -m repro_torch.launch.multichip [--world 4]
        [--out build/results/torch_multichip.json]
"""
from __future__ import annotations

import argparse
import json
import time
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


def parity_rows(rank, world, cases, device="cpu"):
    """One rank of :func:`run_parity` on the initialised group: every
    case's row."""
    mesh = mesh_lib.make_agent_mesh(device_type=device)
    return [parity_case(t, p, c, mesh, device) for t, p, c in cases]


def run_parity(world: int, cases=None, *, backend: str = "gloo",
               timeout_s: float = 120.0) -> list:
    """Spawn ``world`` processes on this host (a gloo group through a
    file store) and run :func:`parity_case` for each case in each of
    them. Returns every rank's rows; raises if a rank failed, hung or
    disagreed with its emulation."""
    cases = parity_cases(world) if cases is None else cases
    device = "cuda" if backend == "nccl" else "cpu"
    got = mesh_lib.run_on_group(world, parity_rows, cases, device,
                                backend=backend, timeout_s=timeout_s)
    rows = [dict(rank=r, **row) for r, rank_rows in enumerate(got)
            for row in rank_rows]
    wrong = [row for row in rows if not row["ok"]]
    if wrong:
        raise RuntimeError(f"mesh path disagrees with its emulation: {wrong}")
    return rows


def lm_mesh_case(mesh, case: dict) -> dict:
    """One LM case on a data x model ``mesh`` (the tensor- and
    data-parallel transformer, :mod:`repro_torch.sharding.parallel`), this
    rank's view: ``case`` names a reduced arch (``arch``, field
    ``overrides``) and the batch (``batch`` x ``seq``). Every rank draws
    the same full params and batch on the CPU (seed 0), takes its shards
    by the table and its rows of the batch, and returns its rows' logits,
    the full gradient (gathered), the loss and gradient norm one
    ``make_train_step`` on the mesh reports, and for an MoE arch
    ``moe_block_distributed`` of layer 0 on its rows of ``moe_x``."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import sharded_batch
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import moe, transformer
    from repro_torch.models.api import lm_loss
    from repro_torch.sharding import parallel

    cfg = dataclasses.replace(reduced(get_arch(case["arch"])),
                              **case.get("overrides", {}))
    gen = torch.Generator().manual_seed(0)
    full = transformer.stack_params(transformer.init(cfg, generator=gen,
                                                     device="cpu"))
    toks = torch.randint(0, cfg.vocab_size, (case["batch"], case["seq"] + 1),
                         generator=gen)
    local, specs = parallel.shard_params(full, cfg, mesh)
    tokens, labels = sharded_batch(toks[:, :-1], toks[:, 1:], mesh)
    tp = parallel.TensorParallel(mesh, specs)
    with torch.no_grad():
        logits, _, _ = transformer.forward(local, cfg, tokens, tp=tp)
    batch = {"tokens": tokens, "labels": labels}
    _, grads = value_and_grad(
        lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"], tp=tp),
        local, batch)
    for g in grads.values():
        parallel.sum_over_data(g, mesh)
    full_grads = parallel.gather_params(grads, specs, mesh)
    step, opt = make_train_step(cfg, mesh=mesh, specs=specs)
    _, _, metrics = step(dict(local), opt.init(local), batch)
    row = dict(arch=case["arch"], data_rank=mesh.get_local_rank("data"),
               model_rank=mesh.get_local_rank("model"),
               logits=logits.numpy(), loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]),
               grads={k: v.numpy() for k, v in full_grads.items()},
               split={k: "model" in s for k, s in specs.items()})
    if cfg.moe is not None and "moe_x" in case:
        x = torch.from_numpy(case["moe_x"])
        rows = x.shape[0] // mesh.size(0)
        r = row["data_rank"]
        p = transformer.param_tree(local, cfg).blocks[0].mlp
        with torch.no_grad():
            y, aux = moe.moe_block_distributed(
                p, cfg, x[r * rows:(r + 1) * rows], mesh, tp=tp)
        row.update(moe_y=y.numpy(), moe_aux=float(aux))
    return row


def lm_mesh_rows(rank, world, cases, data: int, model: int) -> list:
    """One rank of :func:`run_lm_parity` on the initialised group."""
    mesh = mesh_lib.make_host_mesh(data, model, device_type="cpu")
    return [lm_mesh_case(mesh, case) for case in cases]


def run_lm_parity(cases, *, data: int = 2, model: int = 2,
                  timeout_s: float = 120.0) -> list:
    """Spawn a gloo group of ``data`` x ``model`` processes on this host
    and run :func:`lm_mesh_case` for each case in each; every rank's rows,
    in rank order (the caller holds them to the one-process port)."""
    return mesh_lib.run_on_group(data * model, lm_mesh_rows, cases, data,
                                 model, timeout_s=timeout_s)


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
