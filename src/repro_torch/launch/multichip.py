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
C3. :func:`dry_run_sharded` and :func:`dry_run_distributed` are the JAX
harness's compile-and-inspect checks on a fake process group (rank 0 of
8 or K ranks, nothing moved): no (K, K) buffer among the shapes a masked
round produces, the wire collective present, an int8 wire carrying int8,
the C3 ledger clean. Its donation check (JX3) has no counterpart: eager
PyTorch donates no buffer.

For the LM zoo, :func:`run_lm_parity` spawns a data x model gloo group
and runs :func:`lm_mesh_case` on each rank: the tensor- and data-parallel
transformer's logits, loss, gradient and one Adam step, which the tests
hold to the one-process port (tests/test_torch_sharding.py).

Run (an NCCL group, one card per process, then the memory bound on card
0; it refuses by name on a host with fewer cards than ``--world``)::

    PYTHONPATH=src python -m repro_torch.launch.multichip [--world 4]
        [--backend nccl|gloo] [--out build/results/torch_multichip.json]

``--backend gloo`` runs the group on the CPU, and then H1, which reads
the card's memory, does not run: the report and stdout say so.
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


def agent_mesh(n: int = 8, device_type=None):
    """1-D mesh of ``n`` positions (axis ``"agents"``) over the initialised
    process group, which must have ``n`` ranks: the JAX package's
    ``agent_mesh`` (there ``n`` of the forced host devices), here
    :func:`repro_torch.launch.mesh.make_agent_mesh`."""
    return mesh_lib.make_agent_mesh(n, device_type=device_type)


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
    mesh = agent_mesh(world, device_type=device)
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


def _masked_round_records(topo, plan, codec, world, n, **kw):
    """One masked round of ``plan`` at rank 0 of a ``FakeStore`` group of
    ``world`` ranks (collectives move nothing, so values are not
    checked): (the engine, its recorder). The params are CPU tensors of
    this rank's rows."""
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.hlo_analysis import StepRecorder

    fake_group(world)
    try:
        mesh = agent_mesh(world, device_type="cpu")
        eng = masked_engine(topo, plan, codec, mesh=mesh, **kw)
        rows = eng.local_rows
        params = {"w": torch.zeros((rows.stop - rows.start, n),
                                   dtype=torch.float32)}
        state = eng.init_state(params)
        rec = StepRecorder()
        t0 = time.perf_counter()
        with rec.recording():
            eng.step(params, state, t=ROUND_T)
        return eng, rec, time.perf_counter() - t0
    finally:
        mesh_lib.destroy_local_group()


def _wire_checks(eng, rec, label: str) -> tuple:
    """(report fields, violations) of a recorded round: the plan's wire
    collective carries bytes, an int wire carries int8, and the C3 ledger
    (:func:`repro_torch.analysis.costmodel.collective_ledger`) is clean."""
    from repro_torch.analysis.costmodel import collective_ledger
    from repro_torch.launch.hlo_analysis import collective_bytes

    meta = eng.audit_meta()
    wire = tuple(meta["wire_collective"] or ())
    records = [c for _, c in rec.collectives]
    on_wire = [c for c in records if c.kind in wire]
    dtypes = sorted({d for c in on_wire for d in c.dtypes})
    fields = dict(collectives={k: v for k, v in collective_bytes(
        records).items() if v}, wire=list(wire), wire_dtypes=dtypes)
    violations = []
    if not sum(c.nbytes for c in on_wire):
        violations.append(f"layout: no {wire} bytes in the {label} round: "
                          "the wire collective vanished")
    if (meta.get("codec") or "").startswith("int8") and "int8" not in dtypes:
        violations.append(f"layout: {wire} carries {dtypes} but no int8: "
                          "the int8 wire was decoded before the collective")
    ledger, c3 = collective_ledger(meta, records, f"multichip:{label}")
    fields["ledger"] = {"priced_bytes": ledger.priced_bytes,
                        "control_bytes": ledger.control_bytes,
                        "unpriced_bytes": ledger.unpriced_bytes}
    violations += [f"C3: {f.message}" for f in c3]
    return fields, violations


def dry_run_sharded(k: int = 4096, *, num_blocks: int = 8,
                    codec: str = "int8", n: int = 64, verbose=True) -> dict:
    """One masked sharded round at K = ``k`` on a fake group of
    ``num_blocks`` ranks (the JAX package's ``dry_run_sharded``, which
    compiles for forced host devices): H1, no (K, K) buffer among the
    shapes the round's ops produced
    (:func:`repro_torch.launch.hlo_analysis.square_buffers`); the wire
    collective present and an int8 wire carrying int8; the C3 ledger
    clean. The JAX harness's donation check (JX3) has no counterpart:
    eager PyTorch does not donate buffers."""
    from repro_torch.launch.hlo_analysis import square_buffers

    eng, rec, secs = _masked_round_records(
        topo_lib.ring(k), "sharded", codec, num_blocks, n,
        num_blocks=num_blocks)
    fields, violations = _wire_checks(eng, rec, f"sharded/{codec}")
    squares = square_buffers(rec.shapes, k)
    violations = [f"H1: ({d}, {d}) {dt} buffer ({b / 1e6:.0f} MB) in the "
                  f"MASKED sharded round at K={k}"
                  for dt, d, b in squares] + violations
    report = dict(plan="sharded", k=k, num_blocks=num_blocks, codec=codec,
                  dropout_p=DROPOUT_P, seconds=round(secs, 2),
                  square_buffers=squares, violations=violations, **fields)
    if verbose:
        print(f"== sharded K={k} blocks={num_blocks} codec={codec} "
              f"p={DROPOUT_P}: collectives {report['collectives']} wire "
              f"{report['wire']}:{report['wire_dtypes']}; square buffers "
              f">= {k}: {squares or 'none'}")
    return report


def dry_run_distributed(k: int = 8, *, codec: str = "int8", n: int = 64,
                        verbose=True) -> dict:
    """One masked distributed round, one agent a rank of a fake group of
    ``k`` ranks (the JAX package's ``dry_run_distributed``): the p2p
    wire present, an int8 wire carrying int8, the C3 ledger clean."""
    eng, rec, secs = _masked_round_records(topo_lib.ring(k), "distributed",
                                           codec, k, n)
    fields, violations = _wire_checks(eng, rec, f"distributed/{codec}")
    report = dict(plan="distributed", k=k, codec=codec, dropout_p=DROPOUT_P,
                  seconds=round(secs, 2), violations=violations, **fields)
    if verbose:
        print(f"== distributed K={k} codec={codec} p={DROPOUT_P}: "
              f"collectives {report['collectives']} wire "
              f"{report['wire']}:{report['wire_dtypes']}")
    return report


def parity_mesh_vs_emulation(k: int = 32, *, num_blocks: int = 8,
                             codec: str = "int8", verbose: bool = True,
                             timeout_s: float = 120.0) -> dict:
    """Both multi-rank plans on a gloo group of ``num_blocks`` processes
    against their emulations without a mesh, on one masked round each:
    the sharded plan over a ring of ``k`` agents (bit for bit), the
    distributed plan over a ring of ``num_blocks`` agents (within
    :func:`tolerance`). The JAX package's ``parity_mesh_vs_emulation``
    (there over several rounds of ``scan_rounds`` on forced host
    devices), here :func:`run_parity`. Returns ``{"rows", "violations"}``."""
    cases = [(topo_lib.ring(k), "sharded", codec),
             (topo_lib.ring(num_blocks), "distributed", codec)]
    try:
        rows, violations = run_parity(num_blocks, cases,
                                      timeout_s=timeout_s), []
    except RuntimeError as e:
        rows, violations = [], [f"parity: {e}"]
    if verbose:
        for row in rows:
            if row["rank"] == 0:
                print(f"== parity {row['plan']} K={row['K']}: mesh vs "
                      f"emulation max|d|={row['max_abs_err']:.2e} "
                      f"(bit_equal={row['bit_equal']})")
    return {"rows": rows, "violations": violations}


def lm_case_inputs(case: dict):
    """A case's config, full params (``stack_params``), tokens (B, S + 1 +
    ``serve``) and, for the encoder-decoder, frames (B, T_enc, d): drawn
    on the CPU from seed 0, the same in every process."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(reduced(get_arch(case["arch"])),
                              **case.get("overrides", {}))
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    full = model.stack_params(model.init(cfg, generator=gen, device="cpu"))
    toks = torch.randint(0, cfg.vocab_size,
                         (case["batch"], case["seq"] + 1 + case.get("serve", 0)),
                         generator=gen)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn(case["batch"], cfg.encdec.encoder_seq_len,
                             cfg.d_model, generator=gen)
    return cfg, full, toks, frames


def serve_logits(model, cfg, params, toks, frames, prompt: int, steps: int,
                 *, tp=None, mesh=None) -> list:
    """Last-position logits of a prefill of ``toks[:, :prompt]`` and of
    ``steps`` decode steps fed ``toks[:, prompt + i]`` (teacher forcing),
    from fresh caches (on a mesh: this rank's shards by the table)."""
    from repro_torch.sharding import parallel

    caches = model.init_cache(cfg, toks.shape[0], prompt + steps,
                              device=toks.device)
    if mesh is not None:
        caches = parallel.shard_cache(caches, mesh)
    kw = {} if tp is None else {"tp": tp}
    out = []
    with torch.no_grad():
        f = {} if frames is None else {"embeddings": frames}
        logits, caches, _ = model.forward(params, cfg, toks[:, :prompt],
                                          caches=caches, cache_index=0,
                                          last_only=True, **f, **kw)
        out.append(logits[:, -1].float().cpu().numpy())
        for i in range(steps):
            logits, caches, _ = model.forward(
                params, cfg, toks[:, prompt + i:prompt + i + 1],
                caches=caches, cache_index=prompt + i, **kw)
            out.append(logits[:, -1].float().cpu().numpy())
    return out


def lm_mesh_case(mesh, case: dict) -> dict:
    """One LM case on a data x model ``mesh`` (the tensor- and
    data-parallel forward of every LM family, :mod:`repro_torch.sharding.
    parallel`), this rank's view: ``case`` names a reduced arch (``arch``,
    field ``overrides``) and the batch (``batch`` x ``seq``). Every rank
    draws the same full params and batch on the CPU
    (:func:`lm_case_inputs`), takes its shards by the table and its rows
    of the batch, and returns its rows' logits, the full gradient
    (gathered), the loss and gradient norm one ``make_train_step`` on the
    mesh reports, for an MoE arch ``moe_block_distributed`` of layer 0 on
    its rows of ``moe_x``, and with ``serve`` > 0 its rows' logits of a
    prefill of ``seq`` tokens and ``serve`` decode steps from caches
    sharded by the table (:func:`serve_logits`)."""
    from repro_torch.data.pipeline import sharded_batch
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import moe, transformer
    from repro_torch.models.api import get_model, lm_loss
    from repro_torch.sharding import parallel

    cfg, full, toks, frames = lm_case_inputs(case)
    model = get_model(cfg)
    S = case["seq"]
    local, specs = parallel.shard_params(full, cfg, mesh)
    tokens, labels = sharded_batch(toks[:, :S], toks[:, 1:S + 1], mesh)
    rows_all, _ = sharded_batch(toks, toks, mesh)
    kw = {}
    if frames is not None:
        kw["embeddings"], _ = sharded_batch(frames, frames, mesh)
    tp = parallel.TensorParallel(mesh, specs)
    with torch.no_grad():
        logits, _, _ = model.forward(local, cfg, tokens, tp=tp, **kw)
    batch = dict(tokens=tokens, labels=labels)
    if frames is not None:
        batch["frames"] = kw["embeddings"]
    _, grads = value_and_grad(
        lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"],
                             embeddings=b.get("frames"), tp=tp),
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
    if case.get("serve"):
        row["serve"] = serve_logits(model, cfg, local, rows_all,
                                    kw.get("embeddings"), S, case["serve"],
                                    tp=tp, mesh=mesh)
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
                    help="processes of the group")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl (default): one card per process, and the H1 "
                         "memory bound on card 0; gloo: the group on the "
                         "CPU, without H1")
    ap.add_argument("--out", default="build/results/torch_multichip.json")
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count()
    if args.backend == "nccl" and cards < args.world:
        raise SystemExit(
            f"multichip: --backend nccl needs one card per process, and "
            f"this host has {cards} card(s) for --world {args.world}; pass "
            "--backend gloo to run the group on the CPU (H1 then does not "
            "run)")
    t0 = time.perf_counter()
    rows = run_parity(args.world, backend=args.backend)
    report = {"backend": args.backend, "parity": rows,
              "seconds": time.perf_counter() - t0}
    if args.backend == "nccl":
        report["h1"] = [h1_memory(codec=c) for c in (None, "int8")]
    else:
        report["h1_not_run"] = (
            "H1 reads the card's peak allocation of one masked sharded "
            "round; the gloo group runs on the CPU, so H1 did not run")
    for row in rows:
        print(f"rank {row['rank']} {row['plan']:11s} codec={row['codec']} "
              f"K={row['K']}: bit_equal={row['bit_equal']} max err "
              f"{row['max_abs_err']} (tolerance {row['tolerance']:.3g})")
    for row in report.get("h1", []):
        print(f"H1 K={row['K']} N={row['n_params']} codec={row['codec']}: "
              f"added {row['added_bytes']} B <= {row['bound_bytes']} B")
    if "h1_not_run" in report:
        print(f"H1 did not run: {report['h1_not_run']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
