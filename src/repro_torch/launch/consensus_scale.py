"""Consensus-round scaling sweep on the port: the twin of the JAX
package's ``benchmarks/consensus_scale.py``, section for section and
key for key, so the two JSON files can be diffed.

Every timed step goes through
:class:`repro_torch.core.engine.ConsensusEngine`. Sections:

* ``rows`` — one round per K ∈ {12, 64, 256, 1024} × graph family ×
  dtype under the ``dense`` plan (the (K, K) matmul), ``auto`` and, where
  the degree test lets the gather run, the ``sparse`` plan forced (B2),
  priced with Eq. (11). The sparse rows decide the ``auto`` floor
  (:func:`floor_from_rows`). At K = 256 ``auto`` is held to the plain
  per-agent version (bit for bit when it picks sparse). ``--n-params``
  runs this sweep at more widths than the reference's 2048 (the main
  path's ``fc1.w``, 262,144, and the whole paper-DQN, 811,524).
* ``cluster_engine_rows`` — the case study's own cluster engine (K = 2,
  H = 1, the full paper-DQN stacked over 2 agents): dense against sparse.
* ``codec_rows`` — one compressed round per codec × family (error
  feedback on, ``auto`` plan).
* ``sharded_rows`` — the ``sharded`` plan at K ∈ {4096, 16384} per codec,
  4 blocks in one process (B1/B2 once per block per leaf).
* ``casestudy_eq11`` — the 12-robot case study's round joules per codec.
* ``rounds_loop`` — µs per round of the chunked FL driver at chunk ∈ {1,
  8, 32} on the case-study round shape (clusters(6, 2)).
* ``dropout_rows`` — fading links: ``scan_rounds`` drawing each round's
  survival on the device against the host-prefetch pattern
  (``topology.dropout`` on the host, one ``step(mask=)`` per round).
* ``telemetry_rows`` — the chunked FL driver with telemetry off,
  buffered and streaming.
* ``mask_scale_rows`` — one masked round, per-lane σ against the (K, K)
  rebuild, bit-identical, at K ∈ {1024, 4096}.
* ``async_rows`` — lockstep against staleness-tolerant rounds.

Gates (as the reference's): ``--smoke`` asserts the int8 case-study
drop ≥ 3×, chunk 32 ≤ 1.15 × chunk 1 per round, buffered telemetry ≤
1.75 × off; the full run asserts the masked K = 4096 round ≥ 5× faster
per lane than the rebuild. On the card every time is a median of CUDA
event times (at least 3 runs after a warm-up); on the CPU it is the host
clock, and the JSON's ``timer`` says which.

Run:  python -m repro_torch.launch.consensus_scale [--quick|--smoke]
          [--device cuda] [--n-params 2048,262144,811524]
          [--out build/results/torch_consensus_scale.json]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.comms import codecs as codecs_lib
from repro_torch.core import consensus, energy
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine
from repro_torch.kernels import ref

KS = (12, 64, 256, 1024)
FAMILIES = ("ring", "torus", "small_world", "star", "cluster",
            "hierarchical")
DTYPES = ("float32", "bfloat16")
N_PARAMS = 2048          # flat params per agent (the reference's width)
EQUIV_K = 256
CODECS = codecs_lib.CODECS   # none / bf16 / int8 / int4 / topk:0.05
CODEC_KS = (12, 64)
SHARDED_KS = (4096, 16384)
SHARDED_CODECS = (None, "bf16", "int8", "int4")
SHARDED_BLOCKS = 4
ROUNDS_LOOP_CHUNKS = (1, 8, 32)
DROPOUT_ROUNDS = 64
MASK_SCALE_KS = (1024, 4096)
REPS = 5                 # timed runs per median (R3: at least 3)
TURNS = 4                # turns of the dense / auto / sparse comparison
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Clock:
    """Per-call times on ``device``: CUDA events around each call on the
    card (one synchronize at the end), the host clock on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.name = "cuda_events" if self.cuda else "host_clock"

    def samples_us(self, fn, reps: int):
        """µs of each of ``reps`` calls of ``fn``."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
            for a, b in ev:
                a.record()
                fn()
                b.record()
            torch.cuda.synchronize(self.device)
            return [a.elapsed_time(b) * 1e3 for a, b in ev]
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return times

    def median_us(self, fn, *args, reps: int = REPS, warmup: int = 1):
        """Median µs of one call, after ``warmup`` calls."""
        for _ in range(warmup):
            fn(*args)
        return statistics.median(self.samples_us(lambda: fn(*args), reps))

    def compare_us(self, fns: dict, reps: int = REPS, turns: int = TURNS):
        """{name: (median, first quartile, third quartile)} µs per call
        of each function, timed in turns (A B C, C B A, ...) of ``reps``
        calls each after one warm-up call each, so that drift on the host
        falls on every function alike."""
        for fn in fns.values():
            fn()
        names = list(fns)
        got = {k: [] for k in names}
        for t in range(turns):
            for k in (names if t % 2 == 0 else names[::-1]):
                got[k] += self.samples_us(fns[k], reps)
        out = {}
        for k, v in got.items():
            q1, _, q3 = statistics.quantiles(v, n=4)
            out[k] = (statistics.median(v), q1, q3)
        return out


def _stacked(K, n, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((K, n), generator=g, device=device)
    return {"w": x.to(_DTYPES[dtype])}


def _make(fam, K):
    try:
        return topo_lib.make(fam, K)
    except ValueError as e:                 # e.g. K not tileable
        print(f"skip {fam} K={K}: {e}")
        return None


def _oracle(mix, x):
    """The plain version over the same padded sparse structure."""
    idx, sig = consensus.sparse_structure(mix)
    xf = x.to(torch.float32)
    return ref.consensus_update_pop_reference(
        xf, torch.as_tensor(idx, device=x.device),
        torch.as_tensor(sig, device=x.device))


def sweep(clock, ks, families, dtypes, n_params=(N_PARAMS,), *,
          equiv_k=EQUIV_K):
    p_cal = energy.paper_calibrated("fig3")
    dev = clock.device
    rows = []
    for n in n_params:
        for K in ks:
            for dtype_name in dtypes:
                x = _stacked(K, n, dtype_name, dev)
                for fam in families:
                    topo = _make(fam, K)
                    if topo is None:
                        continue
                    mix = topo.mixing()
                    bits = n * x["w"].element_size() * 8     # b(W)
                    joules = topo.round_comm_joules(p_cal, model_bits=bits)
                    base = dict(K=K, topology=fam, dtype=dtype_name,
                                n_params=n, max_degree=topo.max_degree,
                                k_times_h=K * max(topo.max_degree, 1),
                                links=topo.links_per_round(),
                                model_bits=bits,
                                joules_eq11_per_round=joules)
                    engines = {"dense": ConsensusEngine(topo, plan="dense"),
                               "auto": ConsensusEngine(topo, plan="auto")}
                    if consensus.degree_path(mix) == "sparse":
                        engines["sparse"] = ConsensusEngine(topo,
                                                            plan="sparse")
                    us = clock.compare_us({k: (lambda e=e: e.step(x))
                                           for k, e in engines.items()})
                    line = f"K={K:5d} N={n:7d} {fam:12s} {dtype_name:8s}"
                    for impl, eng in engines.items():
                        med, q1, q3 = us[impl]
                        row = {**base, "impl": impl, "plan": eng.plan.kind,
                               "us_per_round": med,
                               "us_quartiles": [q1, q3]}
                        if impl != "dense":
                            row["speedup_vs_xla"] = us["dense"][0] / max(
                                med, 1e-9)
                        rows.append(row)
                        line += f"  {impl}({eng.plan.kind}) {med:10.1f}us"
                    print(f"{line}  eq11 {joules:10.3f} J/round", flush=True)
                    if (K == equiv_k and dtype_name == "float32"
                            and n == n_params[0]):
                        _hold_to_oracle(rows, engines["auto"], mix, x,
                                        equiv_k, fam)
                del x
    return rows


def _hold_to_oracle(rows, eng, mix, x, equiv_k, fam):
    """``auto`` at K = ``equiv_k`` against the plain per-agent version:
    bit for bit on the sparse plan (the kernel's own contract), within
    1e-5 on the dense fallback."""
    got = eng.step(x)[0]["w"].float()
    want = _oracle(mix, x["w"]).float()
    row = next(r for r in reversed(rows) if r["impl"] == "auto")
    if eng.plan.kind == "sparse":
        if not torch.equal(got, want):
            raise AssertionError(f"auto path NOT bit-equal to the plain "
                                 f"version at K={equiv_k} ({fam})")
        row["bit_equal_oracle_at_K"] = equiv_k
        print(f"        {fam}: auto == plain version (bit-equal, "
              f"K={equiv_k})")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        row["allclose_oracle_at_K"] = equiv_k
        print(f"        {fam}: auto (dense) ≈ plain version (K={equiv_k})")


def cluster_engine_rows(clock, seed: int = 0):
    """The case study's own consensus engine: one 2-robot cluster (K = 2,
    H = 1) over the full paper-DQN (10 leaves), dense against sparse."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dqn

    dev = clock.device
    cfg = get_arch("paper-dqn")
    g = torch.Generator(device=dev).manual_seed(seed)
    agents = [dqn.init(cfg, generator=g, device=dev) for _ in range(2)]
    x = {k: torch.stack([a[k] for a in agents]) for k in agents[0]}
    n = sum(v[0].numel() for v in x.values())
    topo = topo_lib.clusters(1, 2)
    engines = {plan: ConsensusEngine(topo, plan=plan)
               for plan in ("dense", "sparse", "auto")}
    us = clock.compare_us({k: (lambda e=e: e.step(x))
                           for k, e in engines.items()})
    rows = []
    for plan, eng in engines.items():
        med, q1, q3 = us[plan]
        rows.append(dict(K=2, topology="cluster", dtype="float32",
                         n_params=n, leaves=len(x), max_degree=1,
                         k_times_h=2, impl=plan, plan=eng.plan.kind,
                         us_per_round=med, us_quartiles=[q1, q3],
                         speedup_vs_xla=us["dense"][0] / max(med, 1e-9)))
        print(f"cluster engine K=2 paper-dqn ({n} params, {len(x)} leaves) "
              f"{plan:6s} ({eng.plan.kind}) {med:10.1f} us/round "
              f"(quartiles {q1:.1f}, {q3:.1f})", flush=True)
    return rows


def floor_from_rows(rows):
    """The ``auto`` floor the rows give, by the JAX package's rule: the
    K·H of the first f32 row (ascending K·H) where the sparse plan beats
    the dense one, every row below it losing. Rows are the f32 ``sparse``
    rows (only where the degree test lets the gather run); the rows at or
    above the floor where sparse lost are listed beside it."""
    f32 = sorted((r for r in rows if r["impl"] == "sparse"
                  and r["dtype"] == "float32"), key=lambda r: r["k_times_h"])
    if not f32:
        return {"floor": None, "rows": 0}
    floor = next((r["k_times_h"] for r in f32 if r["speedup_vs_xla"] > 1.0),
                 None)
    losses = [dict(K=r["K"], topology=r["topology"], n_params=r["n_params"],
                   k_times_h=r["k_times_h"], speedup=r["speedup_vs_xla"])
              for r in f32 if r["speedup_vs_xla"] <= 1.0]
    return {"floor": floor, "rows": len(f32), "losses": losses,
            "smallest_speedup": min(r["speedup_vs_xla"] for r in f32),
            "largest_speedup": max(r["speedup_vs_xla"] for r in f32)}


def codec_sweep(clock, ks, families, codecs):
    """One compressed round per codec × topology (error feedback on,
    ``auto`` plan) and its codec-priced Eq.-(11) joules."""
    p_cal = energy.paper_calibrated("fig3")
    dev = clock.device
    rows = []
    for K in ks:
        x = _stacked(K, N_PARAMS, "float32", dev)
        for fam in families:
            topo = _make(fam, K)
            if topo is None:
                continue
            full_bits = N_PARAMS * 32
            for spec in codecs:
                eng = ConsensusEngine(topo, codec=spec)
                codec = eng.codec
                joules = eng.round_comm_joules(p_cal, model_bits=full_bits)
                state = eng.init_state(x)
                us = clock.median_us(lambda e=eng: e.step(x, state))
                name = codec.name if codec is not None else "none"
                rows.append(dict(
                    K=K, topology=fam, codec=name,
                    wire_bits_per_model=(codec.price_bits(full_bits)
                                         if codec is not None
                                         else float(full_bits)),
                    joules_eq11_per_round=joules, us_per_round=us,
                    plan=eng.plan.kind))
                print(f"K={K:5d} {fam:12s} codec={name:10s} "
                      f"{us:10.1f}us  eq11 {joules:10.4f} J/round",
                      flush=True)
    return rows


def sharded_rows(clock, ks=SHARDED_KS, families=("ring",),
                 codecs=SHARDED_CODECS, num_blocks=SHARDED_BLOCKS):
    """The ``sharded`` plan at K ≫ the reference's core count: blocks of
    K / num_blocks agents, codec wires gathered, no (K, K) stack; wall and
    codec-priced Eq.-(11) joules per codec."""
    p_cal = energy.paper_calibrated("fig3")
    dev = clock.device
    rows = []
    for K in ks:
        x = _stacked(K, N_PARAMS, "float32", dev)
        for fam in families:
            topo = _make(fam, K)
            if topo is None:
                continue
            full_bits = N_PARAMS * 32
            for spec in codecs:
                eng = ConsensusEngine(topo, codec=spec, plan="sharded",
                                      num_blocks=num_blocks)
                joules = eng.round_comm_joules(p_cal, model_bits=full_bits)
                state = eng.init_state(x)
                us = clock.median_us(lambda e=eng: e.step(x, state))
                name = eng.codec.name if eng.codec is not None else "none"
                rows.append(dict(
                    K=K, topology=fam, codec=name, plan="sharded",
                    num_blocks=num_blocks,
                    wire_bits_per_model=(eng.codec.price_bits(full_bits)
                                         if eng.codec is not None
                                         else float(full_bits)),
                    joules_eq11_per_round=joules, us_per_round=us))
                print(f"K={K:5d} {fam:12s} sharded codec={name:10s} "
                      f"{us:12.1f}us  eq11 {joules:10.4f} J/round",
                      flush=True)
        del x
    return rows


def _case_round(device, seed=0):
    """The 12-robot case-study round shape of ``rounds_loop`` and
    ``telemetry_rows``: clusters(6, 2), N_PARAMS-wide models, each robot
    resampling minibatches from one 20-step episode per round for B_i = 2
    local steps, an unreachable target evaluated every round."""
    K, B_i, FEAT, BATCH = 12, 2, 16, 4
    topo = topo_lib.clusters(6, 2)
    g = torch.Generator(device=device).manual_seed(seed)
    stacked = {"w": torch.randn((K, N_PARAMS), generator=g, device=device)}

    def loss_fn(p, b):
        return ((p["w"][:FEAT] - b["tgt"]) ** 2).mean()

    def sample_batches(gen, t):
        ep = torch.randn((K, 20, FEAT), generator=gen, device=device) * 0.01
        idx = torch.randint(0, 20, (K, B_i, BATCH), generator=gen,
                            device=device)
        return {"tgt": ep[torch.arange(K, device=device)[:, None, None],
                          idx]}

    def target_fn(sp):
        m = sp["w"].square().mean()
        return m < 0.0, m                 # unreachable: time full loops

    return topo, stacked, loss_fn, sample_batches, target_fn


def _drive(clock, run, rounds):
    """Median µs per round of ``run()`` (whole loops), 3 runs after a
    warm-up."""
    return clock.median_us(run, reps=3) / rounds


def rounds_loop_rows(clock, chunks=ROUNDS_LOOP_CHUNKS, rounds: int = 128):
    """µs per round of the FL round LOOP: chunk 1 reads the device every
    round (the host-loop pattern of ``run_fl_until``), larger chunks once
    per chunk (``run_fl_until_scan``); the same rounds and bits."""
    from repro_torch.core import federated

    dev = clock.device
    topo, stacked, loss_fn, sample_batches, target_fn = _case_round(dev)
    eng = ConsensusEngine(topo)
    rows, host_us = [], None
    for chunk in chunks:
        def run(c=chunk):
            gen = torch.Generator(device=dev).manual_seed(1)
            return federated.run_fl_until_scan(
                loss_fn, stacked, sample_batches, eng, 0.05,
                target_fn=target_fn, max_rounds=rounds, generator=gen,
                chunk=c)
        med = _drive(clock, run, rounds)
        if chunk == 1:
            host_us = med
        speedup = (host_us / med) if host_us else 1.0
        rows.append(dict(
            K=12, topology="cluster", n_params=N_PARAMS, local_steps=2,
            rounds=rounds, chunk=chunk,
            driver="host-loop" if chunk == 1 else "scanned",
            us_per_round=med, speedup_vs_host_loop=speedup))
        print(f"rounds_loop chunk={chunk:3d}  {med:9.1f} us/round  "
              f"({speedup:.2f}x vs host loop, median of 3)", flush=True)
    return rows


def telemetry_rows(clock, rounds: int = 128, chunk: int = 16):
    """µs per round of the chunked FL driver with telemetry off,
    buffered (rows ride the chunk's one read) and streaming (one more
    read per round), on the ``rounds_loop`` round shape; the same params
    in all three."""
    from repro_torch import telemetry as telemetry_lib
    from repro_torch.core import federated

    dev = clock.device
    topo, stacked, loss_fn, sample_batches, target_fn = _case_round(dev)
    rows, off_us = [], None
    for mode in ("off", "buffered", "streaming"):
        eng = ConsensusEngine(topo)
        tel = (None if mode == "off"
               else telemetry_lib.Telemetry(mode=mode, capacity=rounds))

        def run(e=eng, tel=tel):
            if tel is not None:
                tel.reset()
            gen = torch.Generator(device=dev).manual_seed(1)
            return federated.run_fl_until_scan(
                loss_fn, stacked, sample_batches, e, 0.05,
                target_fn=target_fn, max_rounds=rounds, generator=gen,
                chunk=chunk, telemetry=tel)
        med = _drive(clock, run, rounds)
        if mode == "off":
            off_us = med
        rows.append(dict(
            K=12, topology="cluster", n_params=N_PARAMS, chunk=chunk,
            rounds=rounds, telemetry=mode, us_per_round=med,
            overhead_vs_off=med / max(off_us, 1e-9)))
        print(f"telemetry_rows {mode:10s} chunk={chunk:3d} "
              f"{med:9.1f} us/round  ({med / max(off_us, 1e-9):.2f}x "
              "vs telemetry off, median of 3)", flush=True)
    return rows


def _capture_seconds(engine) -> float:
    """Seconds the engine's ``scan_rounds`` programs spent capturing (0 on
    the CPU, where nothing is captured)."""
    return sum(r.capture_seconds for r in engine.program_records())


def dropout_rows(clock, rounds: int = DROPOUT_ROUNDS, p: float = 0.2,
                 seed: int = 0, configs=None):
    """µs per round of a fading-link round loop: ``scan_rounds`` drawing
    every round's survival on the device in one call, against the
    host-prefetch pattern (each round's surviving Topology built on the
    host by ``topology.dropout``, its mask copied in, one ``step(mask=)``
    per round); the same params either way, checked."""
    if configs is None:
        configs = (("cluster", topo_lib.clusters(6, 2), "dense"),
                   ("ring", topo_lib.ring(256), "sparse"))
    dev = clock.device
    rows = []
    for fam, topo, plan in configs:
        x = _stacked(topo.K, N_PARAMS, "float32", dev)
        eng = ConsensusEngine(topo, plan=plan,
                              graph=topo_lib.GraphProcess.dropout(p, seed))

        def scan(e=eng):
            return e.scan_rounds(x, rounds=rounds)[0]

        def host(e=eng, topo=topo):
            s = x
            for rt in topo_lib.dropout(topo, p, seed, rounds=rounds):
                s = e.step(s, mask=torch.as_tensor(rt.adjacency,
                                                   device=dev))[0]
            return s
        # the first scan_rounds call captures its round program (on the
        # card): made here, outside the timing, and printed on its own (the
        # rows keep the reference's keys)
        if not torch.equal(scan()["w"], host()["w"]):
            raise AssertionError(f"dropout rows {fam}: in-scan and "
                                 "host-prefetch rounds disagree")
        capture_s = _capture_seconds(eng)
        us_scan = clock.median_us(scan, reps=3) / rounds
        us_host = clock.median_us(host, reps=3) / rounds
        for mode, us in (("in-scan", us_scan), ("host-prefetch", us_host)):
            rows.append(dict(
                K=topo.K, topology=fam, plan=plan, dropout_p=p,
                rounds=rounds, mode=mode, us_per_round=us,
                speedup_vs_host_prefetch=us_host / max(us, 1e-9)))
        print(f"dropout_rows {fam:10s} {plan:7s} in-scan {us_scan:9.1f} "
              f"us/round  host-prefetch {us_host:9.1f} us/round  "
              f"({us_host / max(us_scan, 1e-9):.2f}x; capture "
              f"{capture_s:.3f} s, untimed)", flush=True)
    return rows


def mask_scale_rows(clock, ks=MASK_SCALE_KS, p: float = 0.2, seed: int = 0,
                    n_params: int = 256, min_speedup_at_4096=5.0):
    """µs of ONE masked round at scale: the engine's per-lane path
    (per-edge draws over the (K, H) lanes, σ renormalised on the lanes)
    against the (K, K) rebuild it replaced (``round_mask``,
    ``masked_mixing``, the rebuilt σ gathered back to the lanes); outputs
    bit-identical, asserted first. The K = 4096 row must be at least
    ``min_speedup_at_4096``× faster (None: reported only)."""
    dev = clock.device
    rows = []
    for K in ks:
        topo = topo_lib.ring(K)
        x = _stacked(K, n_params, "float32", dev)
        eng = ConsensusEngine(topo, plan="sparse",
                              graph=topo_lib.GraphProcess.dropout(p, seed))
        idx_np, _valid = eng.lane_structure()
        idx = torch.as_tensor(idx_np, device=dev)
        rows_t = torch.arange(K, device=dev)[:, None]

        def after(e=eng):
            return e.step(x, t=3)[0]

        def before(e=eng, idx=idx, rows_t=rows_t):
            mix_t = e.masked_mixing(e.round_mask(3, device=dev))
            sig_t = mix_t[rows_t, idx.long()]
            return consensus.consensus_step(x, e.mix, impl="sparse",
                                            structure=(idx, sig_t))
        if not torch.equal(after()["w"], before()["w"]):
            raise AssertionError(f"per-lane != kk-rebuild at K={K} (one "
                                 "convention)")
        us_after = clock.median_us(after, reps=3)
        us_before = clock.median_us(before, reps=3)
        speedup = us_before / max(us_after, 1e-9)
        for mode, us in (("per-lane", us_after), ("kk-rebuild", us_before)):
            rows.append(dict(
                K=K, topology="ring", plan="sparse", dropout_p=p,
                n_params=n_params, mode=mode, us_per_round=us,
                speedup_vs_kk_rebuild=us_before / max(us, 1e-9)))
        print(f"mask_scale K={K:5d} per-lane {us_after:10.1f} us/round  "
              f"kk-rebuild {us_before:12.1f} us/round  "
              f"({speedup:.1f}x, median of 3)", flush=True)
        if K == 4096 and min_speedup_at_4096 is not None:
            assert speedup >= min_speedup_at_4096, (
                f"masked round at K=4096: per-lane only {speedup:.1f}x "
                f"faster than the (K, K) rebuild (< {min_speedup_at_4096}x)")
    return rows


def async_rows(clock, rounds: int = 64, configs=None):
    """µs per round of the staleness-tolerant loop (availability draws,
    delivered/stale lanes, λ^age σ, freezes, the clock/age carry) against
    the lockstep loop on the same plan; reported, not gated."""
    if configs is None:
        configs = (("cluster", topo_lib.clusters(6, 2), "dense"),
                   ("ring", topo_lib.ring(256), "sparse"))
    dev = clock.device
    rows = []
    for fam, topo, plan in configs:
        x = _stacked(topo.K, N_PARAMS, "float32", dev)
        sync_eng = ConsensusEngine(topo, plan=plan)
        asyn_eng = ConsensusEngine(
            topo, plan=plan,
            agents=topo_lib.AgentProcess.bernoulli(0.6, seed=0),
            tau=3, staleness_decay=0.9)
        # one untimed call each captures the round programs (on the card)
        for e in (sync_eng, asyn_eng):
            e.scan_rounds(x, rounds=rounds)
        capture_s = {"lockstep": _capture_seconds(sync_eng),
                     "staleness": _capture_seconds(asyn_eng)}
        us_sync = clock.median_us(
            lambda: sync_eng.scan_rounds(x, rounds=rounds), reps=3) / rounds
        us_asyn = clock.median_us(
            lambda: asyn_eng.scan_rounds(x, rounds=rounds), reps=3) / rounds
        for mode, us in (("lockstep", us_sync), ("staleness", us_asyn)):
            rows.append(dict(
                K=topo.K, topology=fam, plan=plan, rounds=rounds,
                mode=mode, us_per_round=us,
                overhead_vs_lockstep=us / max(us_sync, 1e-9)))
        print(f"async_rows   {fam:10s} {plan:7s} lockstep {us_sync:9.1f} "
              f"us/round  staleness {us_asyn:9.1f} us/round  "
              f"({us_asyn / max(us_sync, 1e-9):.2f}x, median of 3; "
              f"captures {capture_s['lockstep']:.3f} / "
              f"{capture_s['staleness']:.3f} s, untimed)",
              flush=True)
    return rows


def casestudy_eq11(codecs):
    """Codec-priced Eq.-(11) joules of ONE round of the paper's 12-robot
    case study (6 clusters × 2 robots, calibrated b(W))."""
    p_cal = energy.paper_calibrated("fig3")
    topo = topo_lib.clusters(6, 2)
    out = {}
    base = topo.round_comm_joules(p_cal)
    for spec in codecs:
        j = topo.round_comm_joules(p_cal, codec=spec)
        name = (codecs_lib.resolve_codec(spec).name if spec is not None
                else "none")
        out[name] = {"joules_eq11_per_round": j,
                     "drop_vs_uncompressed": base / j}
        print(f"casestudy 12-robot  codec={name:10s} "
              f"eq11 {j:8.2f} J/round  ({base / j:.1f}x vs f32)")
    return out


def _device_info(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run(*, quick=False, smoke=False, device="cuda", codec=None,
        n_params=(N_PARAMS,), out="build/results/torch_consensus_scale.json"):
    """Run the sweep (``smoke``: the reference's tier-1 sections and
    gates) and write the JSON; returns the payload."""
    clock = Clock(device)
    codecs = (tuple(None if c in ("none", "") else c
                    for c in codec.split(","))
              if codec else (None,) + tuple(c for c in CODECS
                                            if c != "none"))
    t0 = time.perf_counter()
    if smoke:
        ks, families, dtypes = (64,), ("ring",), ("float32",)
        rows, cl_rows = [], []
        codec_rows = codec_sweep(clock, (64,), ("ring",), ("int8",))
        shard_rows = sharded_rows(clock, (64,), ("ring",), ("int8",),
                                  num_blocks=4)
        assert shard_rows and shard_rows[0]["us_per_round"] > 0
        cs = casestudy_eq11((None, "int8"))
        assert cs["int8+ef"]["drop_vs_uncompressed"] >= 3.0
        # the chunked driver must not be slower per round than the
        # per-round host loop (median of 3 both sides, 1.15x tolerance)
        loop_rows = rounds_loop_rows(clock, chunks=(1, 32), rounds=64)
        assert (loop_rows[-1]["us_per_round"]
                <= 1.15 * loop_rows[0]["us_per_round"]), loop_rows
        drop_rows = dropout_rows(
            clock, rounds=16,
            configs=(("cluster", topo_lib.clusters(6, 2), "dense"),))
        # buffered telemetry within 1.75x of telemetry off (median of 3)
        tel_rows = telemetry_rows(clock, rounds=64, chunk=16)
        assert (tel_rows[1]["us_per_round"]
                <= 1.75 * tel_rows[0]["us_per_round"]), tel_rows
        mask_rows = mask_scale_rows(clock, ks=(256,),
                                    min_speedup_at_4096=None)
        as_rows = async_rows(
            clock, rounds=16,
            configs=(("cluster", topo_lib.clusters(6, 2), "dense"),))
    else:
        ks = tuple(k for k in KS if k <= 256) if quick else KS
        dtypes = ("float32",) if quick else DTYPES
        families = FAMILIES
        rows = sweep(clock, ks, families, dtypes, n_params)
        cl_rows = cluster_engine_rows(clock)
        codec_rows = codec_sweep(clock, CODEC_KS, families, codecs)
        shard_rows = sharded_rows(clock)
        cs = casestudy_eq11(codecs)
        loop_rows = rounds_loop_rows(clock)
        drop_rows = dropout_rows(clock)
        tel_rows = telemetry_rows(clock)
        mask_rows = mask_scale_rows(clock)
        as_rows = async_rows(clock)
    payload = {
        "bench": "consensus_scale",
        "backend": torch.device(device).type,
        "device": _device_info(device),
        "timer": clock.name,
        "n_params_per_agent": N_PARAMS,
        "n_params_sweep": list(n_params),
        "sparse_gather_floor": consensus.SPARSE_GATHER_FLOOR,
        "ks": list(ks), "families": list(families),
        "dtypes": list(dtypes),
        "rows": rows,
        "cluster_engine_rows": cl_rows,
        "floor": floor_from_rows(rows + cl_rows),
        "codec_rows": codec_rows,
        "sharded_rows": shard_rows,
        "casestudy_eq11": cs,
        "rounds_loop": loop_rows,
        "dropout_rows": drop_rows,
        "telemetry_rows": tel_rows,
        "mask_scale_rows": mask_rows,
        "async_rows": as_rows,
        "seconds": time.perf_counter() - t0,
    }
    if smoke:
        payload["smoke"] = True
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1))
    print(f"wrote {path} ({len(rows)} rows, {len(codec_rows)} codec rows; "
          f"floor {payload['floor']})", flush=True)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="K <= 256, f32 only")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tier-1 sections and gates only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--codec", default=None,
                    help="comma list of codec specs for the codec sweep "
                         f"(default: {','.join(c or 'none' for c in CODECS)})")
    ap.add_argument("--n-params", default=str(N_PARAMS),
                    help="comma list of per-agent widths of the dense-vs-"
                         "sparse sweep (default 2048, the reference's)")
    ap.add_argument("--out",
                    default="build/results/torch_consensus_scale.json")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"consensus_scale: --device {args.device} but no "
                         "CUDA device is available; pass --device cpu for a "
                         "CPU run")
    run(quick=args.quick, smoke=args.smoke, device=args.device,
        codec=args.codec,
        n_params=tuple(int(v) for v in args.n_params.split(",")),
        out=args.out)


if __name__ == "__main__":
    main()
