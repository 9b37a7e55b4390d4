"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Phases (any failure exits non-zero; nothing is caught):

1. env        — torch/CUDA versions, the card's name and power limit.
2. build      — compile the four CUDA kernels from ``src/repro_torch/
                kernels/csrc`` (one nvcc per source, in parallel), timed as
                set-up; ptxas's registers and spills of each.
3. kernels    — each kernel against its plain PyTorch version on the card,
                on full-width paper-DQN params stacked over K = 256 agents
                (ring and small-world graphs; codecs None and bf16 for the
                f32/decoded kernel, int8 / int4 / int8:b64 for the fused
                int-wire kernel) and at the case study's own shapes (one
                2-robot cluster); then kernel, plain-version and library
                times and the memory bound at the largest leaf (fc1.w).
4. engine     — ``ConsensusEngine(ring(256), plan="auto")`` resolves to the
                sparse plan and agrees with the dense plan.
5. casestudy  — the paper's MAML + consensus-FL case study, forced onto the
                sparse plan, with codec int8 and with no codec; each run
                is counted from 0 and must launch its own kernel once per
                leaf per FL round, and the other kernel never.
6. dynamic    — the same path on fading links and sleeping agents: the
                engine at K = 256 (paper-DQN stacks, ring and small-world,
                codecs None / int8 / int8:b64 / bf16, links fading, agents
                sleeping, both): 4 rounds of ``scan_rounds`` on the sparse
                plan equal its steps bit for bit, and each round the dense
                plan from the same state within the engine gate; the
                always-on reduction and a round in which every agent
                sleeps, bit for bit; masks drawn on the card equal the
                CPU's; B1/B2 on σ tables with zeros and λ^age weights equal
                their plain versions; the case study with dropout_p = 0.3
                and robots awake with p = 0.75 (τ = 2, λ = 0.9), codecs
                int8 and None: launches as in ``casestudy``, the bill of the
                wires the card delivered == the host replay and no more
                than the static bill, E_total = Eq. (12) with the measured
                joules; a profile of one dynamic FL round and the launches
                its draws add.
7. drivers    — per-round Eq.-(11) telemetry and the chunked protocol
                drivers at full width (paper-DQN × K = 256, small_world(k=4),
                sparse plan, links fading with p = 0.3, agents awake with
                p = 0.7, τ = 2, λ = 0.9): (a) 8 rounds of ``scan_rounds``
                with buffered telemetry on the int8 wire equal the
                telemetry-off rounds bit for bit, every row's link and
                per-agent counts and the summed joules equal the host replay
                (``==``), B1 launches 10 × 8 either way; off / buffered /
                streaming walls and the kernels a row adds; (b)
                ``run_fl_until_scan`` at chunk 8 against ``run_fl_until``
                (f32 wire, B2) on a regression pull toward seeded targets,
                the hit mid-chunk: params, t_i, history and the live rows bit
                for bit, B2 launches 10 × rounds computed; (c) the ``dynamic``
                int8 case study again with streaming telemetry into
                ``build/telemetry.jsonl``: results, params and launches equal
                the telemetry-off run, per-task streamed joules == the
                post-hoc bill, t_i events per task, the log passes the
                schema; (d) ``MTLProtocol`` with the paper-DQN Q-network
                regressed on one-step rewards (2-robot clusters, t0 = 5,
                max_rounds 16; dense at K = 2, so no kernel launches).
8. paper      — the paper's experiments at full paper-DQN width on the
                sparse plan, codec None (B2 carries every combine): (a)
                ``CaseStudy.run`` at ``r_target=-1e9``, t0 2, max_rounds 4,
                at chunk 1 and chunk 4: every task's t_i, history and
                adapted params ``==``, B2 launches 10 × rounds computed (60
                / 240), B1 none; (b) the Fig. 4 sweep reduced to 1 seed,
                grid (0, 2, 4), max_rounds 8: energies ``==`` recomputed
                from the mean t_i, and grid (4,) alone gives the same t_i
                at t0 = 4; (c) the MAML stage alone: ms per meta round
                (median of 7), kernels per meta round and the busy share;
                (d) the twin of ``examples/async_fleet.py`` (int8, sparse,
                B1): rows == the host replay, joules == the bill.
9. profile    — host wall and device kernel time of one case-study FL
                round (``torch.profiler``), the device's busy share.
10. lm_kernels — the RG-LRU scan and flash-attention kernels against their
                plain versions at recurrentgemma-9b's serving shapes (bf16
                attention at scores of std 1 and of std 20, which the
                softcap bends; a ragged bf16 case with a window that cuts
                kv tiles; and a ragged f32 case), then kernel,
                plain-version and library (SDPA at softcap 0) times, each
                bound, B4's achieved TFLOP/s, and ptxas's registers and
                spills of the two sources. Every time is the median of 20
                calls.
11. serve     — ``repro_torch.launch.serve`` on full-width, full-depth
                recurrentgemma-9b (random weights): 4 prompts of 4096
                tokens, 32 greedy tokens; each prefill must launch the scan
                26 and the attention kernel 12 times, decode neither. Then
                a profile of one prefill and 4 decode steps (host wall,
                kernels, device busy share, B3/B4's share of the prefill);
                prefill + 1 decode step against the full forward at full
                width and one pattern period (3 layers).

The line before the last is the kernels JSON; the last is the ``ok`` line.

Run:  python3 chip_smoke.py
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 dense tensor cores
F32_TOL = 1e-6                  # kernel vs plain: same ops, same order
BF16_TOL = 0.0                  # ... and the same final rounding
K_POP = 256
DEVICE = "cuda"
#: the port's kernel wrappers (``repro_torch.kernels.ops``), in table order
KERNELS = ("quant_consensus_pop", "consensus_update_pop", "rglru_scan",
           "flash_attention")
ARCH = "recurrentgemma-9b"
SERVE = dict(batch=4, prompt_len=4096, gen=32)
B3_TOL = 1e-6                   # max |kernel - plain| / max(1, |plain|)
B4_F32_TOL = 2e-3               # abs + rel (the JAX package's own gate)
# bf16: the plain version rounds each probability to bf16 (relative error
# <= 2^-8) before P·V, the kernel carries them as two bf16 terms (within
# 2^-16), and both round the output to bf16 (<= 1 ulp apart, ulp <= 2^-7
# |x|). So
#   |kernel - plain| <= 2^-7 |plain| + 2^-8 Σ_t p_t |v_t|,
# gated with that and 1e-5 for f32 summation order
B4_BF16_REL, B4_BF16_PV, B4_BF16_ABS = 2.0 ** -7, 2.0 ** -8, 1e-5
DECODE_TOL = 6e-2               # decode vs full forward (test_arch_smoke)


T_START = time.perf_counter()


def phase(name):
    """Print a phase header with the seconds since the script started."""
    print(f"\n== {name} == (t = {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def stamp(what):
    """Print the seconds since the script started after a step."""
    print(f"{what} done at t = {time.perf_counter() - T_START:.1f} s",
          flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def median_ms(fn, iters=20, warmup=2):
    """Median device time of one call, by CUDA events around each call.
    The events are recorded back to back with one synchronize at the end,
    so the card does not sit idle between a start event and its call
    while the host launches it."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """(least time in ms, what bounds it) for the given bytes and flops."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def ptxas_summary(name):
    """ptxas's register, shared-memory and spill lines for one source."""
    from repro_torch.kernels import build
    log = build.BUILD_LOGS.get(name, "not built in this run")
    return " | ".join(ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln or "built" in ln)


def launch_counts():
    """Every kernel wrapper's launch counter, by kernel name."""
    from repro_torch.kernels import ops
    return {n: getattr(ops, n).launches for n in KERNELS}


def zero_counts():
    from repro_torch.kernels import ops
    for n in KERNELS:
        getattr(ops, n).launches = 0


def stacked_params(cfg, K, generator):
    from repro_torch.models import dqn as qmodel
    agents = [qmodel.init(cfg, generator=generator, device=DEVICE)
              for _ in range(K)]
    return {k: torch.stack([a[k] for a in agents]) for k in agents[0]}


def check_kernels(cfg, generator):
    from repro_torch.comms import codecs
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ops, ref

    errs = {"consensus_update_pop": 0.0, "quant_consensus_pop": 0.0}

    def compare(name, got, want, tol, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        errs[name] = max(errs[name], err)
        if not torch.isfinite(got.float()).all() or err > tol:
            fail(f"{name} {what}: max |kernel - plain| = {err} > {tol}")

    cases = [("ring", K_POP, topology.ring(K_POP)),
             ("small_world", K_POP, topology.small_world(K_POP, k=4, seed=1)),
             ("cluster", 2, topology.clusters(1, 2))]
    pops = {}
    for gname, K, topo in cases:
        if K not in pops:
            pops[K] = stacked_params(cfg, K, generator)
        idx, sig = (torch.as_tensor(a, device=DEVICE)
                    for a in consensus.sparse_structure(topo.mixing()))
        for leaf, x in pops[K].items():
            xf = x.reshape(K, -1)
            what = f"{gname} K={K} H={idx.shape[1]} {leaf} N={xf.shape[1]}"
            bf16 = codecs.get_codec("bf16")
            for spec in (None, "bf16"):
                xin = xf if spec is None else bf16.decode_leaf(
                    bf16.encode_leaf(xf), xf.shape[1])
                compare("consensus_update_pop",
                        ops.consensus_update_pop(xin, idx, sig),
                        ref.consensus_update_pop_reference(xin, idx, sig),
                        F32_TOL, f"{what} codec={spec}")
            xb = xf.to(torch.bfloat16)
            compare("consensus_update_pop",
                    ops.consensus_update_pop(xb, idx, sig),
                    ref.consensus_update_pop_reference(xb, idx, sig),
                    BF16_TOL, f"{what} bf16 tensors")
            for spec in ("int8", "int4", "int8:b64"):
                c = codecs.get_codec(spec)
                enc = c.encode_leaf(xf)
                compare("quant_consensus_pop",
                        ops.quant_consensus_pop(xf, enc["q"], enc["scale"],
                                                idx, sig, qblock=c.block),
                        ref.quant_consensus_pop_reference(
                            xf, enc["q"], enc["scale"], idx, sig, c.block),
                        F32_TOL, f"{what} codec={spec}")
        print(f"{gname:11s} K={K:3d} H={idx.shape[1]}: {len(pops[K])} leaves "
              f"x (None, bf16, bf16 tensors, int8, int4, int8:b64) agree; "
              f"max err so far {errs} (tolerance f32 {F32_TOL}, "
              f"bf16 tensors {BF16_TOL})", flush=True)
    return pops, errs


def time_kernels(pops, errs):
    from repro_torch.comms import codecs
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ops, ref

    rows = {}
    for K, topo in ((K_POP, topology.ring(K_POP)), (2, topology.clusters(1, 2))):
        mix = topo.mixing()
        idx, sig = (torch.as_tensor(a, device=DEVICE)
                    for a in consensus.sparse_structure(mix))
        H = idx.shape[1]
        xf = pops[K]["fc1.w"].reshape(K, -1)
        N = xf.shape[1]
        M = torch.as_tensor(consensus._effective_mix(mix), device=DEVICE)
        # bytes: x read and out written (4 + 4 per element), lane tables;
        # flops: sub, mul, add per neighbour per element, then x + acc
        b2 = bound(8 * K * N + 8 * K * H, 3 * K * N * H + K * N)
        t_b2 = (median_ms(lambda: ops.consensus_update_pop(xf, idx, sig)),
                median_ms(lambda: ref.consensus_update_pop_reference(
                    xf, idx, sig)),
                median_ms(lambda: M @ xf))
        c = codecs.get_codec("int8")
        enc = c.encode_leaf(xf)
        q, s = enc["q"], enc["scale"]
        # bytes: x, out (4 + 4), int8 lanes (1) per element, scales, lanes;
        # flops: dequant, sub, mul, add per neighbour, own dequant, x + acc
        b1 = bound(9 * K * N + 4 * K + 8 * K * H, 4 * K * N * H + 2 * K * N)
        t_b1 = (median_ms(lambda: ops.quant_consensus_pop(xf, q, s, idx, sig)),
                median_ms(lambda: ref.quant_consensus_pop_reference(
                    xf, q, s, idx, sig)))
        print(f"fc1.w K={K} H={H} N={N}: consensus_update_pop kernel_ms="
              f"{t_b2[0]} plain_ms={t_b2[1]} library_ms(matmul)={t_b2[2]} "
              f"bound_ms={b2[0]} ({b2[1]})", flush=True)
        print(f"fc1.w K={K} H={H} N={N}: quant_consensus_pop(int8) kernel_ms="
              f"{t_b1[0]} plain_ms={t_b1[1]} library_ms=None "
              f"bound_ms={b1[0]} ({b1[1]})", flush=True)
        if K == K_POP:
            rows["consensus_update_pop"] = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/consensus_update.cu",
                replaces="src/repro/kernels/consensus_update.py:34",
                ms=t_b2[0], plain_ms=t_b2[1], bound_ms=b2[0], bound_by=b2[1],
                library_ms=t_b2[2])
            rows["quant_consensus_pop"] = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/quant_consensus.cu",
                replaces="src/repro/kernels/quant_consensus.py:76",
                ms=t_b1[0], plain_ms=t_b1[1], bound_ms=b1[0], bound_by=b1[1],
                library_ms=None)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    print("kernels: " + ", ".join(f"{n} ({r['route']}, {r['source']})"
                                  for n, r in rows.items()), flush=True)
    return rows


def check_engine(pops):
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine

    x = pops[K_POP]
    for spec in (None, "int8", "int8:b64", "bf16"):
        eng = ConsensusEngine(topology.ring(K_POP), codec=spec, plan="auto")
        if eng.plan.kind != "sparse":
            fail(f"ring(256) codec={spec} resolved to {eng.plan.kind!r}")
        dense = ConsensusEngine(topology.ring(K_POP), codec=spec, plan="dense")
        got, st = eng.step(x, eng.init_state(x))
        want, wst = dense.step(x, dense.init_state(x))
        worst = 0.0
        for k in x:
            # round to nearest and zero EF state put the same lanes on the
            # wire in both plans, so they differ only in summation order:
            # 1e-5 plus a few f32 ulps of the largest value
            atol = 1e-5 + 4 * torch.finfo(torch.float32).eps * float(
                x[k].abs().max())
            err = float((got[k] - want[k]).abs().max())
            if not torch.isfinite(got[k]).all() or err > atol:
                fail(f"engine {spec} {k}: sparse vs dense {err} > {atol}")
            if st is not None and float((st[k] - wst[k]).abs().max()) > atol:
                fail(f"engine {spec} {k}: EF residuals disagree")
            worst = max(worst, err / atol)
        print(f"ring(256) codec={spec}: plan={eng.plan.kind}; sparse vs dense "
              f"max err {worst:.3g} of tolerance", flush=True)


def run_casestudy():
    """Each codec's run is one main path: the launch counters are set to 0
    just before it and read just after. The int8 wire must launch only the
    fused int-wire kernel, no codec only the f32 kernel, each once per leaf
    per FL round computed (whole chunks, frozen tail included)."""
    from repro_torch.core import energy
    from repro_torch.rl.casestudy import CaseStudy

    t0, max_rounds = 4, 8
    own = {"int8": "quant_consensus_pop", None: "consensus_update_pop"}
    by_path, walls = {}, {}
    for spec in ("int8", None):
        cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                       codec=spec, device=DEVICE)
        if cs.engine.plan.kind != "sparse":
            fail(f"case study engine resolved to {cs.engine.plan.kind!r}")
        leaves = len(cs.init_params(torch.Generator(device=DEVICE)))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        zero_counts()
        t = time.perf_counter()
        res = cs.run(gen, t0, max_rounds=max_rounds)
        torch.cuda.synchronize()
        wall = walls[spec] = time.perf_counter() - t
        got = launch_counts()
        s = res.summary()
        if len(res.meta_history) != t0 or not all(
                v == v and abs(v) < float("inf") for v in res.meta_history):
            fail(f"meta losses not finite: {res.meta_history}")
        if len(res.rounds_per_task) != 6 or not all(
                1 <= r <= max_rounds for r in res.rounds_per_task):
            fail(f"t_i out of range: {res.rounds_per_task}")
        want = energy.total_energy(cs.energy_params, t0, 3,
                                   res.rounds_per_task, cs.cluster_topology,
                                   cs.codec)
        if abs(res.E_total - want) > 1e-9 * want:
            fail(f"E_total {res.E_total} != Eq. (12) {want}")
        computed = sum(min(-(-r // cs.chunk) * cs.chunk, max_rounds)
                       for r in res.rounds_per_task)
        want_launches = {n: computed * leaves if n == own[spec] else 0
                         for n in got}
        print(f"codec={spec}: t_i={res.rounds_per_task} "
              f"E_total_kJ={s['E_total_kJ']} meta_loss={res.meta_history} "
              f"wall_s={wall} launches={got} (expected {want_launches}: "
              f"{computed} FL rounds x {leaves} leaves)", flush=True)
        if got != want_launches:
            fail(f"case study codec={spec} launched {got}, expected "
                 f"{want_launches}")
        by_path[str(spec).lower()] = got
    return by_path, walls


# -- dynamic: fading links and sleeping agents -----------------------------------

DYN_PROCESSES = ("dropout", "async", "both")


def dynamic_kw(name):
    """Engine arguments of one dynamic process: links fading with p = 0.3,
    agents awake with p = 0.7 (τ = 2, λ = 0.9), or both."""
    from repro_torch.core import topology
    graph = dict(graph=topology.GraphProcess.dropout(0.3, seed=1))
    agents = dict(agents=topology.AgentProcess.bernoulli(0.7), tau=2,
                  staleness_decay=0.9)
    return {"dropout": graph, "async": agents,
            "both": dict(graph, **agents)}[name]


def engine_gate(x):
    """The engine phase's gate: same lanes on the wire, only the summation
    order differs: 1e-5 plus 4 f32 ulps of the leaf's largest value."""
    return 1e-5 + 4 * torch.finfo(torch.float32).eps * float(x.abs().max())


def check_dynamic_engine(pops):
    """K = 256 paper-DQN stacks on ring and small_world(k=4), codecs None,
    int8, int8:b64 and bf16, three dynamic processes. The sparse plan's
    4 rounds of ``scan_rounds`` equal the same rounds driven one call at a
    time, bit for bit; in each of those rounds the dense plan, started
    from the same state, agrees within the gate (params and EF residuals)
    and draws the same activity and ages. Then the always-on reduction
    and the dead round, bit for bit."""
    from repro_torch.core import topology
    from repro_torch.core.engine import AsyncState, ConsensusEngine

    x = pops[K_POP]
    worst = 0.0
    for gname, topo in (("ring", topology.ring(K_POP)),
                        ("small_world", topology.small_world(K_POP, k=4,
                                                             seed=1))):
        for spec in (None, "int8", "int8:b64", "bf16"):
            for proc in DYN_PROCESSES:
                kw = dynamic_kw(proc)
                sparse = ConsensusEngine(topo, codec=spec, plan="sparse", **kw)
                dense = ConsensusEngine(topo, codec=spec, plan="dense", **kw)
                got, got_st = sparse.scan_rounds(x, rounds=4)
                p, st = x, sparse.init_state(x)
                is_async = sparse.agents is not None
                if is_async:
                    ast = sparse.init_async_state(device=DEVICE)
                    dast = dense.init_async_state(device=DEVICE)
                for t in range(4):
                    if is_async:
                        sp, sst, ast, ar = sparse.async_step(p, st, t=t,
                                                             state=ast)
                        dp, dst, dast, dar = dense.async_step(p, st, t=t,
                                                              state=dast)
                        idx = torch.as_tensor(sparse.lane_structure()[0],
                                              device=DEVICE).long()
                        rows = torch.arange(K_POP, device=DEVICE)[:, None]
                        valid = torch.as_tensor(sparse.lane_structure()[1],
                                                device=DEVICE)
                        if not torch.equal(ar.act, dar.act) or not torch.equal(
                                ar.age[valid], dar.age[rows, idx][valid]):
                            fail(f"dynamic {gname} {spec} {proc} round {t}: "
                                 "plans drew different activity or ages")
                    else:
                        sp, sst = sparse.step(p, st, t=t)
                        dp, dst = dense.step(p, st, t=t)
                    for k in x:
                        gate = engine_gate(p[k])
                        err = float((sp[k] - dp[k]).abs().max())
                        if not torch.isfinite(sp[k]).all() or err > gate:
                            fail(f"dynamic {gname} {spec} {proc} round {t} "
                                 f"{k}: sparse vs dense {err} > {gate}")
                        if sst is not None and float(
                                (sst[k] - dst[k]).abs().max()) > gate:
                            fail(f"dynamic {gname} {spec} {proc} round {t} "
                                 f"{k}: EF residuals disagree")
                        worst = max(worst, err / gate)
                    p, st = sp, sst
                for k in x:
                    if not torch.equal(got[k], p[k]) or (
                            st is not None and not torch.equal(got_st[k], st[k])):
                        fail(f"dynamic {gname} {spec} {proc}: scan_rounds "
                             "differs from its rounds one by one")
        print(f"{gname}({K_POP}): codecs (None, int8, int8:b64, bf16) x "
              f"{DYN_PROCESSES}: 4 rounds of scan_rounds on the sparse plan "
              f"= its steps bit for bit; each round within the dense plan's "
              f"gate; max err so far {worst:.3g} of the gate", flush=True)

    ring = topology.ring(K_POP)
    for spec in (None, "int8"):
        for graph in (None, topology.GraphProcess.dropout(0.3, seed=1)):
            lock = ConsensusEngine(ring, codec=spec, plan="sparse", graph=graph)
            on = ConsensusEngine(ring, codec=spec, plan="sparse", graph=graph,
                                 agents=topology.AgentProcess.always_on())
            a, sa = lock.scan_rounds(x, rounds=2)
            b, sb = on.scan_rounds(x, rounds=2)
            if any(not torch.equal(a[k], b[k]) for k in x) or (
                    sa is not None and any(not torch.equal(sa[k], sb[k])
                                           for k in x)):
                fail(f"always-on codec={spec} graph={graph!r} differs from "
                     "lockstep")
        dead = ConsensusEngine(ring, codec=spec, plan="sparse",
                               agents=topology.AgentProcess.departure(
                                   [0] * K_POP))
        st = None if spec is None else {k: torch.full_like(v, 1e-3)
                                        for k, v in x.items()}
        p, st2, _, ar = dead.async_step(
            x, st, t=0, state=dead.init_async_state(device=DEVICE))
        if ar.act.any() or any(not torch.equal(p[k], x[k]) for k in x) or (
                st is not None and any(not torch.equal(st2[k], st[k])
                                       for k in x)):
            fail(f"dead round codec={spec} moved params or residuals")
    print(f"always-on (tau=None) = lockstep bit for bit on the sparse plan "
          f"(static and fading ring({K_POP}), codecs None and int8); a round "
          "in which every agent sleeps leaves params and residuals as they "
          "were", flush=True)


def check_dynamic_masks():
    """Survival and availability drawn on the card for a chunk of rounds
    equal the same draws on the CPU (dense grid, per-edge lanes through
    the engine, per-agent rates)."""
    import numpy as np
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine

    topo = topology.small_world(K_POP, k=4, seed=1)
    ts = torch.arange(3, 11)
    rates = np.random.default_rng(0).uniform(size=K_POP)
    pairs = []
    for dev in ("cpu", DEVICE):
        eng = ConsensusEngine(topo, plan="sparse", **dynamic_kw("both"))
        pairs.append((
            topology.survival_mask(topo.adjacency, 0.3,
                                   topology.survival_key(7, dev),
                                   ts.to(dev)).cpu(),
            eng.round_survival(ts.to(dev)).cpu(),
            eng.availability(ts.to(dev)).cpu(),
            topology.availability_mask(K_POP, rates,
                                       topology.availability_key(5, dev),
                                       ts.to(dev)).cpu()))
    names = ("survival (K, K)", "lanes (K, H)", "bernoulli availability",
             "per-agent availability")
    for name, a, b in zip(names, *pairs):
        if not torch.equal(a, b):
            fail(f"{name} masks drawn on the card differ from the CPU's")
    print(f"masks of rounds 3..10 drawn on the card equal the CPU's: "
          f"{', '.join(names)} (shares True: "
          f"{[float(a.float().mean()) for a in pairs[1]]})", flush=True)


def check_dynamic_kernels(pops, errs):
    """B1 and B2 at the timed leaf (fc1.w, N = 262,144, K = 256) on σ tables
    of async rounds with fading links: zeros on faded, sleeping and
    padding lanes, λ^age weights on stale lanes. Gate as in ``kernels``."""
    from repro_torch.comms import codecs
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.kernels import ops, ref

    xf = pops[K_POP]["fc1.w"].reshape(K_POP, -1)
    for gname, topo in (("ring", topology.ring(K_POP)),
                        ("small_world", topology.small_world(K_POP, k=4,
                                                             seed=1))):
        eng = ConsensusEngine(topo, plan="sparse", **dynamic_kw("both"))
        age = eng.init_async_state(device=DEVICE).age
        fractional = zeros = 0
        for t in range(4):
            ar = eng.async_round(t, age)
            age = ar.age
            idx, sig = eng._lane_sigma(ar.weights)
            w = ar.weights
            fractional += int(((w > 0) & (w < 1)).sum())
            zeros += int((sig == 0).sum())
            for dtype in (torch.float32, torch.bfloat16):
                xd = xf.to(dtype)
                got = ops.consensus_update_pop(xd, idx, sig)
                want = ref.consensus_update_pop_reference(xd, idx, sig)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                errs["consensus_update_pop"] = max(
                    errs["consensus_update_pop"], err)
                if err > (F32_TOL if dtype == torch.float32 else BF16_TOL):
                    fail(f"consensus_update_pop {gname} round {t} {dtype}: "
                         f"{err}")
            for spec in ("int8", "int8:b64"):
                c = codecs.get_codec(spec)
                enc = c.encode_leaf(xf)
                got = ops.quant_consensus_pop(xf, enc["q"], enc["scale"], idx,
                                              sig, qblock=c.block)
                want = ref.quant_consensus_pop_reference(
                    xf, enc["q"], enc["scale"], idx, sig, c.block)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                errs["quant_consensus_pop"] = max(
                    errs["quant_consensus_pop"], err)
                if err > F32_TOL:
                    fail(f"quant_consensus_pop {gname} round {t} {spec}: "
                         f"{err}")
        print(f"{gname}({K_POP}) fc1.w N={xf.shape[1]}: 4 async rounds with "
              f"fading links, {zeros} sigma = 0 lanes and {fractional} "
              f"lambda^age weights; B2 (f32, bf16) and B1 (int8, int8:b64) "
              f"equal their plain versions (max err {errs})", flush=True)


DYN_CS = dict(t0=4, max_rounds=8)


def dynamic_casestudy(spec, telemetry=None):
    """The case study on fading links (p = 0.3) and sleeping robots (awake
    with p = 0.75, τ = 2, λ = 0.9) on the sparse plan."""
    from repro_torch.core import topology
    from repro_torch.rl.casestudy import CaseStudy
    return CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                     codec=spec, dropout_p=0.3,
                     availability=topology.AgentProcess.bernoulli(0.75),
                     tau=2, staleness_decay=0.9, device=DEVICE,
                     telemetry=telemetry)


def run_dynamic_casestudy():
    """The dynamic case study, codecs int8 and None; each run counted
    from 0. Each must launch its own kernel once per leaf per FL round
    computed and the other never; the bill of the wires the card
    delivered equals the host replay (==) and is no more than the static
    bill; E_total is Eq. (12) with the measured joules. Returns the int8
    run too, for the ``drivers`` phase."""
    import numpy as np
    from repro_torch.core import energy
    from repro_torch.rl.casestudy import delivered_comm_joules

    t0, max_rounds = DYN_CS["t0"], DYN_CS["max_rounds"]
    own = {"int8": "quant_consensus_pop", None: "consensus_update_pop"}
    by_path, walls = {}, {}
    for spec in ("int8", None):
        cs = dynamic_casestudy(spec)
        leaves = len(cs.init_params(torch.Generator(device=DEVICE)))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        zero_counts()
        t = time.perf_counter()
        res = cs.run(gen, t0, max_rounds=max_rounds)
        torch.cuda.synchronize()
        walls[spec] = time.perf_counter() - t
        got = launch_counts()
        ep, base = cs.energy_params, cs.cluster_topology
        static = base.round_comm_joules(ep, codec=cs.codec)
        measured = res.fl_comm_joules_measured
        if measured is None or len(measured) != 6:
            fail(f"dynamic case study billed {measured}")
        for tid, t_i in enumerate(res.rounds_per_task):
            lanes = cs.fl_delivered[tid]
            idx, _ = cs._engines[tid].lane_structure()
            masks = np.zeros((t_i, base.K, base.K), bool)
            for r in range(t_i):
                masks[r, np.arange(base.K)[:, None], idx] = lanes[r]
            bill = delivered_comm_joules(base, masks, ep, cs.codec)
            if bill != measured[tid] or bill > t_i * static:
                fail(f"task {tid}: card-delivered bill {bill} vs host replay "
                     f"{measured[tid]}, static {t_i * static}")
        want = energy.maml_energy(ep, t0, cs.network.Q) + sum(
            energy.fl_learning_energy(ep, t_i, base) + c
            for t_i, c in zip(res.rounds_per_task, measured))
        if abs(res.E_total - want) > 1e-9 * want:
            fail(f"E_total {res.E_total} != Eq. (12) {want}")
        computed = sum(min(-(-r // cs.chunk) * cs.chunk, max_rounds)
                       for r in res.rounds_per_task)
        want_launches = {n: computed * leaves if n == own[spec] else 0
                         for n in got}
        print(f"dynamic codec={spec}: t_i={res.rounds_per_task} "
              f"E_total_kJ={res.summary()['E_total_kJ']} comm_J={measured} "
              f"(static bill {[t_i * static for t_i in res.rounds_per_task]}) "
              f"wall_s={walls[spec]} launches={got} (expected "
              f"{want_launches})", flush=True)
        if got != want_launches:
            fail(f"dynamic case study codec={spec} launched {got}, expected "
                 f"{want_launches}")
        by_path[f"dynamic_{str(spec).lower()}"] = got
        if spec == "int8":
            int8_run = (cs, res, got)
    return by_path, walls, int8_run


def profile_dynamic_round(rounds=3):
    """Dynamic FL rounds (2 robots, int8, sparse plan, fading links and
    sleeping robots) as the case study runs them: ``rounds`` rounds fed
    by one chunk's draws, made beforehand. Host wall per round and, from
    ``torch.profiler`` traces, kernels and device time per round; then a
    chunk's draws (8 rounds of survival and availability in one call),
    whose host time and kernels count 1/8 to each round, and one round's
    ``async_round`` + lane σ (inside the round's kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import topology
    from repro_torch.core.engine import AsyncState
    from repro_torch.rl.casestudy import CaseStudy

    cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                   codec="int8", dropout_p=0.3,
                   availability=topology.AgentProcess.bernoulli(0.75), tau=2,
                   staleness_decay=0.9, device=DEVICE)
    eng = cs.engine
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    C = cs.network.devices_per_cluster
    stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
               for k, v in cs.init_params(gen).items()}
    state = eng.init_state(stacked)
    astate = eng.init_async_state(device=DEVICE)
    acts_both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def draws():
        ts = torch.arange(0, cs.chunk, device=DEVICE)
        return eng.round_survival(ts), eng.availability(ts)

    links, acts = draws()

    def run():
        nonlocal stacked, state, astate
        for i in range(rounds):
            ar = eng.async_round(i, astate.age, act=acts[i], link=links[i])
            stacked, state, _ = cs.fl_round(0, stacked, state, gen,
                                            survival=ar.weights, active=ar.act)
            astate = AsyncState(astate.clock + ar.act.to(torch.int32), ar.age)
        torch.cuda.synchronize()

    run()                                            # warm-up
    t = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t) / rounds * 1e3
    with profile(activities=acts_both) as prof:
        run()
    out, kernels = trace_kernels(prof, "casestudy_dynamic_fl_round")
    busy_ms = sum(e.get("dur", 0) for e in kernels) / rounds / 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    draws()
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=acts_both) as prof:
        draws()
        torch.cuda.synchronize()
    _, k_chunk = trace_kernels(prof, "chunk_draws")
    with profile(activities=acts_both) as prof:
        ar = eng.async_round(0, astate.age, act=acts[0], link=links[0])
        eng._lane_sigma(ar.weights)
        torch.cuda.synchronize()
    _, k_round = trace_kernels(prof, "async_round")
    per_round = len(kernels) / rounds + len(k_chunk) / cs.chunk
    wall = wall_ms + draw_ms / cs.chunk
    print(f"dynamic FL round (2 robots, int8, sparse, p=0.3, awake 0.75) "
          f"at chunk {cs.chunk}: wall_ms={wall} kernels_per_round="
          f"{per_round} device_busy_ms={busy_ms} busy_share={busy_ms / wall} "
          f"(trace {out}); of which a chunk's draws: {len(k_chunk)} kernels "
          f"and host_ms={draw_ms} per {cs.chunk} rounds, async_round + lane "
          f"sigma: {len(k_round)} kernels a round", flush=True)
    if kernels:
        top_kernels(kernels, rounds)


# -- drivers: per-round telemetry and the chunked protocol drivers ---------------

DRV_ROUNDS = 8
#: repetitions of each telemetry mode in the walls of ``drivers`` (a)
DRV_REPS = 7
DRV_FL = dict(max_rounds=12, chunk=8, lr=0.3)


def driver_engine(spec):
    """The K = 256 population of the ``drivers`` phase: small_world(k=4),
    sparse plan, links fading (p = 0.3) and agents sleeping (awake with
    p = 0.7, τ = 2, λ = 0.9)."""
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine
    eng = ConsensusEngine(topology.small_world(K_POP, k=4, seed=1), codec=spec,
                          plan="sparse", **dynamic_kw("both"))
    if eng.plan.kind != "sparse":
        fail(f"drivers engine resolved to {eng.plan.kind!r}")
    return eng


def host_replay_masks(topo, rounds):
    """The wires delivered in rounds 0..rounds-1 of ``driver_engine``'s
    processes, replayed from the host streams: (K, K) bools per round."""
    from repro_torch.core import topology
    drops = topology.dropout(topo, 0.3, seed=1, rounds=rounds)
    acts = topology.availability_stream(topology.AgentProcess.bernoulli(0.7),
                                        topo.K, rounds)
    return [d.adjacency & a[:, None] & a[None, :] for d, a in zip(drops, acts)]


def count_kernels(fn, name):
    """Device kernels ``fn`` launches, from a ``torch.profiler`` trace
    (kept as ``build/profile/<name>.json``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return len(trace_kernels(prof, name)[1])


def check_scan_rounds_telemetry(x):
    """(a) 8 rounds of ``scan_rounds`` on the int8 wire: buffered
    telemetry leaves params and EF state bit for bit as telemetry off, and
    launches B1 exactly as often (10 × 8); every row's link counts and
    per-agent counts equal the host replay and the summed joules equal its
    bill (``==``). Then walls of off / buffered / streaming runs (each
    mode ``DRV_REPS`` times, alternating; median and spread) and the
    kernels a row adds per round."""
    import numpy as np
    from repro_torch.core import topology
    from repro_torch.rl.casestudy import delivered_comm_joules
    from repro_torch.telemetry import MemorySink, Telemetry

    eng = driver_engine("int8")
    leaves, R = len(x), DRV_ROUNDS
    want = {n: (leaves * R if n == "quant_consensus_pop" else 0)
            for n in KERNELS}
    runs = {}
    for mode in (None, "buffered"):
        tel = None if mode is None else Telemetry()
        zero_counts()
        out = eng.scan_rounds(x, rounds=R, telemetry=tel)
        torch.cuda.synchronize()
        runs[mode] = (out, launch_counts(), tel)
    (off, off_st), off_n, _ = runs[None]
    (on, on_st), on_n, tel = runs["buffered"]
    if any(not torch.equal(off[k], on[k]) or not torch.equal(off_st[k],
                                                             on_st[k])
           for k in x):
        fail("scan_rounds with telemetry differs from telemetry off")
    if off_n != want or on_n != want:
        fail(f"scan_rounds launched {off_n} (off) / {on_n} (buffered), "
             f"expected {want}")
    topo = eng.topology
    masks = host_replay_masks(topo, R)
    ev = tel.events(driver="consensus")
    if [e["round"] for e in ev] != list(range(R)):
        fail(f"scan_rounds telemetry rounds {[e['round'] for e in ev]}")
    lc = np.asarray(topo.link_class)
    for e, m in zip(ev, masks):
        for cls, code in (("sl", topology.SL), ("ul", topology.UL),
                          ("dl", topology.DL)):
            hit = m & (lc == code)
            if e[f"n_{cls}"] != int(hit.sum()) or \
                    e[f"agent_{cls}"] != hit.sum(0).tolist():
                fail(f"round {e['round']} {cls}: row counts differ from the "
                     "host replay")
    bill = delivered_comm_joules(topo, masks, tel.energy_params, eng.codec)
    if tel.joules(driver="consensus") != bill:
        fail(f"telemetry joules {tel.joules(driver='consensus')} != host "
             f"replay {bill}")
    # each mode DRV_REPS times, the order reversed every other repetition
    # so that a drift of the host's speed falls on every mode alike
    walls = {m: [] for m in ("off", "buffered", "streaming")}
    for rep in range(DRV_REPS):
        for mode in (tuple(walls) if rep % 2 == 0 else tuple(walls)[::-1]):
            t_ = (None if mode == "off" else
                  Telemetry(mode=mode, sinks=(MemorySink(),)))
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.scan_rounds(x, rounds=R, telemetry=t_)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t) * 1e3 / R)
    med = {m: statistics.median(w) for m, w in walls.items()}
    spread = {m: max(w) - min(w) for m, w in walls.items()}
    row_cost = [b - o for b, o in zip(walls["buffered"], walls["off"])]
    stream_cost = [s_ - b for s_, b in zip(walls["streaming"],
                                           walls["buffered"])]
    k_off = count_kernels(lambda: eng.scan_rounds(x, rounds=R),
                          "scan_rounds_off")
    k_on = count_kernels(lambda: eng.scan_rounds(x, rounds=R,
                                                 telemetry=Telemetry()),
                         "scan_rounds_buffered")
    print(f"(a) scan_rounds {R} rounds, K={K_POP} small_world int8 sparse, "
          f"fading + sleeping: telemetry off == buffered bit for bit; "
          f"launches {on_n} both; rows == host replay; joules "
          f"{tel.joules(driver='consensus')} == replay {bill}; edges per "
          f"round {[e['edges'] for e in ev]}, n_active "
          f"{[e['n_active'] for e in ev]}, disagreement "
          f"{[e['disagreement'] for e in ev]}", flush=True)
    print(f"(a) wall ms per round over {DRV_REPS} alternating runs of "
          f"each mode, median (max - min): "
          + ", ".join(f"{m} {med[m]} ({spread[m]})" for m in walls)
          + f"; per repetition, buffered - off: median "
          f"{statistics.median(row_cost)} (min {min(row_cost)}, max "
          f"{max(row_cost)}), streaming - buffered: median "
          f"{statistics.median(stream_cost)} (min {min(stream_cost)}, max "
          f"{max(stream_cost)}); runs {walls}", flush=True)
    print(f"(a) kernels per round off {k_off / R}, buffered {k_on / R} (a "
          f"row adds {(k_on - k_off) / R})", flush=True)
    return on_n


def check_fl_drivers(x):
    """(b) ``run_fl_until_scan`` (chunk 8) against ``run_fl_until`` on the
    f32 wire (B2): each agent pulls each leaf toward a target made from
    the seed (loss ½‖w − w*‖²), the threshold from a probe run so the hit
    lands mid-chunk. Both with buffered telemetry: params, t_i, history
    and the live rows bit for bit; B2 launches 10 × rounds computed."""
    from repro_torch.core import federated
    from repro_torch.telemetry import Telemetry

    eng = driver_engine(None)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    target = {k: torch.randn(v.shape[1:], generator=g, device=DEVICE)
              for k, v in x.items()}
    batches = {k: v.expand((K_POP, 1) + v.shape) for k, v in target.items()}

    def loss(p, b):
        return sum(0.5 * (p[k] - b[k]).square().sum() for k in p)

    def sample(_generator, _t):
        return batches

    def dist(sp):
        return sum((sp[k] - target[k]).square().mean() for k in sp)

    def run(driver, thr, **kw):
        def target_fn(sp):
            m = dist(sp)
            return m < thr, m
        tel = Telemetry()
        zero_counts()
        t = time.perf_counter()
        p, t_i, hist = driver(loss, x, sample, eng, DRV_FL["lr"],
                              target_fn=target_fn,
                              max_rounds=DRV_FL["max_rounds"],
                              generator=torch.Generator(device=DEVICE),
                              telemetry=tel, **kw)
        torch.cuda.synchronize()
        return (p, t_i, hist, tel, launch_counts(),
                time.perf_counter() - t)

    probe = run(federated.run_fl_until_scan, -1.0, chunk=DRV_FL["chunk"])[2]
    thr = probe[2] * 0.999
    res = {"chunk 8": run(federated.run_fl_until_scan, thr,
                          chunk=DRV_FL["chunk"]),
           "chunk 1": run(federated.run_fl_until, thr)}
    p8, t8, h8, tel8, n8, w8 = res["chunk 8"]
    p1, t1, h1, tel1, n1, w1 = res["chunk 1"]
    if not 1 < t8 < DRV_FL["chunk"] or (t8, h8) != (t1, h1) or any(
            not torch.equal(p8[k], p1[k]) for k in p8):
        fail(f"run_fl_until_scan (t_i {t8}, history {h8}) differs from "
             f"run_fl_until (t_i {t1}, history {h1}) or missed mid-chunk")
    if tel8.events(driver="fl") != tel1.events(driver="fl") or \
            len(tel8.events(driver="fl")) != t8:
        fail("run_fl_until_scan live rows differ from run_fl_until's")
    leaves = len(x)
    computed = {"chunk 8": min(-(-t8 // DRV_FL["chunk"]) * DRV_FL["chunk"],
                               DRV_FL["max_rounds"]), "chunk 1": t1}
    for name, n in (("chunk 8", n8), ("chunk 1", n1)):
        want = {k: (leaves * computed[name] if k == "consensus_update_pop"
                    else 0) for k in KERNELS}
        if n != want:
            fail(f"run_fl_until {name} launched {n}, expected {want}")
    print(f"(b) FL drivers K={K_POP} f32 sparse, fading + sleeping: probe "
          f"history {probe}; threshold {thr}; t_i {t8} at chunk 8 == chunk 1, "
          f"params, history and {t8} live rows bit for bit; launches chunk 8 "
          f"{n8} ({computed['chunk 8']} rounds computed), chunk 1 {n1}; wall "
          f"s chunk 8 {w8}, chunk 1 {w1}; joules {tel8.joules()}", flush=True)
    return n8


def run_streaming_casestudy(off):
    """(c) The ``dynamic`` phase's int8 case study again, with streaming
    telemetry into ``build/telemetry.jsonl``: t_i, histories, E_total,
    adapted params and launches equal the telemetry-off run; per task the
    streamed joules equal the post-hoc bill and there are t_i ``fl``
    events; the log passes the port's schema."""
    from repro_torch.kernels import build
    from repro_torch.telemetry import JsonlSink, Telemetry, validate_jsonl

    cs0, res0, n0 = off
    path = build.BUILD_ROOT.parent / "telemetry.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    tel = Telemetry(mode="streaming", sinks=(JsonlSink(path),))
    cs = dynamic_casestudy("int8", telemetry=tel)
    zero_counts()
    t = time.perf_counter()
    res = cs.run(torch.Generator(device=DEVICE).manual_seed(0), DYN_CS["t0"],
                 max_rounds=DYN_CS["max_rounds"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = launch_counts()
    tel.close()
    same = (res.rounds_per_task == res0.rounds_per_task
            and res.meta_history == res0.meta_history
            and res.fl_histories == res0.fl_histories
            and res.E_total == res0.E_total
            and all(torch.equal(cs.fl_params[i][k], cs0.fl_params[i][k])
                    for i in cs0.fl_params for k in cs0.fl_params[i]))
    if not same:
        fail(f"streaming case study t_i {res.rounds_per_task} / E_total "
             f"{res.E_total} differs from telemetry off "
             f"{res0.rounds_per_task} / {res0.E_total} (or its histories "
             "or adapted params do)")
    if got != n0:
        fail(f"streaming case study launched {got}, telemetry off {n0}")
    per_task = [tel.joules(task_id=i) for i in range(6)]
    counts = [len([e for e in tel.events(driver="fl") if e["task_id"] == i])
              for i in range(6)]
    if per_task != res.fl_comm_joules_measured or \
            counts != res.rounds_per_task:
        fail(f"streamed joules {per_task} vs post-hoc "
             f"{res.fl_comm_joules_measured}; events {counts} vs t_i "
             f"{res.rounds_per_task}")
    n_events, errors = validate_jsonl(path)
    if errors or n_events != DYN_CS["t0"] + sum(res.rounds_per_task):
        fail(f"{path}: {n_events} valid events, problems {errors[:5]}")
    print(f"(c) streaming case study (int8, p=0.3, awake 0.75): t_i "
          f"{res.rounds_per_task}, E_total_kJ {res.summary()['E_total_kJ']}, "
          f"histories and adapted params == telemetry off; launches {got} "
          f"== off; streamed joules per task {per_task} == post-hoc bill; "
          f"{n_events} events in {path} pass the schema; wall_s {wall}",
          flush=True)
    return got


def run_protocol():
    """(d) ``MTLProtocol`` on the card: the paper-DQN Q-network regressed
    on the one-step rewards of each gridworld task (q(s, a) → r(s, a) /
    10), the case study's 2-robot clusters and meta tasks, t0 = 5,
    max_rounds 16, buffered telemetry. K = 2 sits below the sparse
    floor, so the engine is dense and no kernel launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import energy
    from repro_torch.core.multitask import ClusterNetwork
    from repro_torch.core.protocol import MTLProtocol
    from repro_torch.models import dqn as qmodel
    from repro_torch.rl import gridworld as gw
    from repro_torch.rl.casestudy import META_TASKS
    from repro_torch.telemetry import Telemetry

    cfg = get_arch("paper-dqn")
    cells = torch.arange(gw.NUM_CELLS, device=DEVICE)
    pos = torch.stack([cells // gw.GRID_H, cells % gw.GRID_H], -1)
    states = gw.one_hot_state(pos)
    rewards = torch.stack([torch.stack(
        [gw.step(pos, torch.full_like(cells, a), tid)[1]
         for a in range(gw.NUM_ACTIONS)], -1) for tid in range(gw.NUM_TASKS)]
    ).to(torch.float32) / 10.0                      # (tasks, 40, 4)

    def loss_fn(p, b):
        return (qmodel.forward(p, cfg, b["x"]) - b["y"]).square().mean()

    def batch(idx, task_id):
        return {"x": states[idx], "y": rewards[task_id][idx]}

    def sample_support(g, task_id, steps):
        return batch(torch.randint(0, gw.NUM_CELLS, (steps, 16), generator=g,
                                   device=DEVICE), task_id)

    def sample_query(g, task_id):
        return batch(torch.randint(0, gw.NUM_CELLS, (16,), generator=g,
                                   device=DEVICE), task_id)

    def target_fn(p, task_id):
        err = loss_fn(p, batch(cells, task_id))
        return err < 0.06, -err

    tel = Telemetry()
    proto = MTLProtocol(
        loss_fn=loss_fn,
        init_fn=lambda g: qmodel.init(cfg, generator=g, device=DEVICE),
        network=ClusterNetwork(num_tasks=gw.NUM_TASKS, devices_per_cluster=2,
                               meta_task_ids=META_TASKS),
        sample_support=sample_support, sample_query=sample_query,
        target_fn=target_fn, inner_lr=0.05, outer_lr=0.05, fl_lr=0.05,
        inner_steps=5, fl_local_steps=10, chunk=8, telemetry=tel)
    t0, max_rounds = 5, 16
    zero_counts()
    t = time.perf_counter()
    res = proto.run(torch.Generator(device=DEVICE).manual_seed(3), t0,
                    max_rounds=max_rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = launch_counts()
    want = energy.total_energy(proto.energy_params, t0, proto.net.Q,
                               res.rounds_per_task, proto.cluster_topology)
    per_round = proto.engine.round_comm_joules(proto.energy_params)
    joules = [tel.joules(task_id=i) for i in range(gw.NUM_TASKS)]
    if (proto.engine.plan.kind != "dense" or any(got.values())
            or len(res.meta_history) != t0
            or not all(abs(v) < float("inf") for v in res.meta_history)
            or not all(1 <= r <= max_rounds for r in res.rounds_per_task)
            or abs(res.E_total - want) > 1e-9 * want
            or joules != [sum([per_round] * r) for r in res.rounds_per_task]
            or len(tel.events(driver="maml")) != t0):
        fail(f"MTLProtocol: plan {proto.engine.plan.kind} launches {got} "
             f"t_i {res.rounds_per_task} meta {res.meta_history} E_total "
             f"{res.E_total} (Eq. (12) {want}) joules {joules}")
    print(f"(d) MTLProtocol paper-DQN regression on the card: plan "
          f"{proto.engine.plan.kind} (K = 2; no kernel launches: {got}); t0 "
          f"{t0}, meta losses {res.meta_history}, t_i {res.rounds_per_task}, "
          f"E_total_kJ {res.summary()['E_total_kJ']}, per-task telemetry "
          f"joules {joules}; wall_s {wall}", flush=True)
    return got


# -- paper: the paper's experiments on the port ---------------------------------

PAPER_C1 = dict(t0=2, max_rounds=4, chunks=(1, 4))
PAPER_SWEEP = dict(seeds=1, max_rounds=8, t0_grid=(0, 2, 4))
#: meta rounds timed alone in (c), and meta rounds in its trace
PAPER_META = dict(reps=7, traced=2)


def paper_casestudy(**kw):
    """The case study at full paper-DQN width on the sparse plan, codec
    None (every combine through B2), as the sweep runs it."""
    from repro_torch.rl.casestudy import CaseStudy
    cs = CaseStudy(plan="sparse", inner_steps=10, outer_lr=0.01,
                   device=DEVICE, **kw)
    if cs.engine.plan.kind != "sparse":
        fail(f"paper case study resolved to {cs.engine.plan.kind!r}")
    return cs


def dqn_leaves():
    """Leaves of the full-width paper-DQN (10)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dqn as qmodel
    return len(qmodel.init(get_arch("paper-dqn"), device=DEVICE))


def b2_only(rounds, leaves):
    """The launch counts of a run that computed ``rounds`` FL rounds of a
    ``leaves``-leaf model on the f32 wire: B2 once per leaf per round."""
    return {n: rounds * leaves if n == "consensus_update_pop" else 0
            for n in KERNELS}


def check_paper_c1():
    """(a) ``CaseStudy.run`` with ``r_target=-1e9`` (every task hits in
    round 1), t0 2, max_rounds 4, at chunk 1 and at chunk 4: every task's
    t_i, history and adapted params and the meta history ``==``; B2
    launches 10 × rounds computed (60 / 240), B1 never."""
    t0, max_rounds = PAPER_C1["t0"], PAPER_C1["max_rounds"]
    runs, by_path = {}, {}
    for chunk in PAPER_C1["chunks"]:
        cs = paper_casestudy(r_target=-1e9, chunk=chunk)
        zero_counts()
        t = time.perf_counter()
        res = cs.run(torch.Generator(device=DEVICE).manual_seed(0), t0,
                     max_rounds=max_rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = launch_counts()
        computed = sum(min(-(-r // chunk) * chunk, max_rounds)
                       for r in res.rounds_per_task)
        want = b2_only(computed, dqn_leaves())
        print(f"(a) chunk {chunk}: t_i {res.rounds_per_task}, meta losses "
              f"{res.meta_history}, {computed} FL rounds computed, launches "
              f"{got} (expected {want}); wall_s {wall}", flush=True)
        if res.rounds_per_task != [1] * 6 or got != want:
            fail(f"C1 run at chunk {chunk}: t_i {res.rounds_per_task}, "
                 f"launches {got}, expected [1] * 6 and {want}")
        runs[chunk] = (res, cs.fl_params)
        by_path[f"paper_c1_chunk{chunk}"] = got
    (r1, p1), (r4, p4) = (runs[c] for c in PAPER_C1["chunks"])
    if (r1.rounds_per_task, r1.fl_histories, r1.meta_history) != \
            (r4.rounds_per_task, r4.fl_histories, r4.meta_history) or any(
                not torch.equal(p1[i][k], p4[i][k]) for i in p1 for k in p1[i]):
        fail("CaseStudy.run at chunk 4 differs from chunk 1 (t_i, histories "
             "or adapted params)")
    print("(a) chunk 1 == chunk 4: every task's t_i, history and adapted "
          "params, and the meta history, bit for bit", flush=True)
    return by_path


def check_paper_sweep():
    """(b) The Fig. 4 sweep reduced to 1 seed, grid (0, 2, 4), max_rounds
    8, chunk 8 (it prints each t0's wall and the FL rounds computed beside
    those used): its energies ``==`` ``_add_energies`` recomputed from the
    JSON's mean t_i, B2 launches 10 × rounds computed; then grid (4,)
    alone gives the same t_i at t0 = 4."""
    from repro_torch.kernels import build
    from repro_torch.rl import fig4_tradeoff

    leaves = dqn_leaves()
    out = build.BUILD_ROOT.parent / "results" / "smoke_torch_fig4.json"
    by_path, results = {}, {}
    for name, grid in (("paper_sweep", PAPER_SWEEP["t0_grid"]),
                       ("paper_sweep_subset", PAPER_SWEEP["t0_grid"][-1:])):
        zero_counts()
        t = time.perf_counter()
        res = fig4_tradeoff.run(seeds=PAPER_SWEEP["seeds"],
                                max_rounds=PAPER_SWEEP["max_rounds"],
                                t0_grid=grid, out=str(out), plan="sparse",
                                device=DEVICE)
        wall = time.perf_counter() - t
        got = launch_counts()
        computed = sum(sum(c) for per_seed in
                       res["run"]["rounds_computed"].values()
                       for c in per_seed)
        want = b2_only(computed, leaves)
        data = json.loads(out.read_text())
        recomputed = {"mean_rounds": data["mean_rounds"], "energies": {}}
        fig4_tradeoff._add_energies(recomputed, grid)
        print(f"(b) grid {grid}: t_i {data['rounds']}, {computed} FL rounds "
              f"computed, launches {got} (expected {want}); wall_s {wall}",
              flush=True)
        if data["run"]["plan"] != "sparse" or got != want or \
                data["energies"] != json.loads(json.dumps(
                    recomputed["energies"])):
            fail(f"sweep grid {grid}: plan {data['run']['plan']}, launches "
                 f"{got} (expected {want}), energies {data['energies']} vs "
                 f"recomputed {recomputed['energies']}")
        results[name] = data
        by_path[name] = got
    t0 = str(PAPER_SWEEP["t0_grid"][-1])
    full, sub = results["paper_sweep"], results["paper_sweep_subset"]
    if full["rounds"][t0] != sub["rounds"][t0]:
        fail(f"t_i at t0={t0}: full grid {full['rounds'][t0]}, subset "
             f"{sub['rounds'][t0]}")
    print(f"(b) subset grid == full grid at t0={t0}: t_i {sub['rounds'][t0]}; "
          f"energies == recomputed; {out}", flush=True)
    return by_path


def measure_meta_round():
    """(c) The MAML stage alone: ``CaseStudy.meta_round`` at full width
    (3 meta tasks, 10 inner steps, first order). Wall ms per meta round
    (median of ``PAPER_META['reps']``, a synchronize around each), then
    kernels per meta round and the device's busy share from one
    ``torch.profiler`` trace. A meta round launches no consensus kernel."""
    from torch.profiler import ProfilerActivity, profile

    cs = paper_casestudy()
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    params = cs.init_params(gen)
    params, _ = cs.meta_round(params, gen)               # warm-up
    zero_counts()
    walls = []
    for _ in range(PAPER_META["reps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, m = cs.meta_round(params, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    got = launch_counts()
    n = PAPER_META["traced"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            params, m = cs.meta_round(params, gen)
        torch.cuda.synchronize()
    out, kernels = trace_kernels(prof, "meta_round")
    wall = statistics.median(walls)
    busy = sum(e.get("dur", 0) for e in kernels) / n / 1e3
    loss = float(m["meta_loss"])
    print(f"(c) meta round (3 tasks x 10 inner steps, paper-DQN): wall ms "
          f"median {wall} (min {min(walls)}, max {max(walls)}; {walls}); "
          f"kernels_per_round={len(kernels) / n} device_busy_ms={busy} "
          f"busy_share={busy / wall}; meta loss {loss}; launches {got} "
          f"(trace {out})", flush=True)
    if any(got.values()) or not abs(loss) < float("inf"):
        fail(f"meta round launched {got} or gave meta loss {loss}")
    if kernels:
        top_kernels(kernels, n)
    else:
        print("profiler trace holds no device kernels: device time not "
              "measured", flush=True)
    return {"paper_meta_round": got}


def check_fleet():
    """(d) The twin of ``examples/async_fleet.py`` on the card, forced onto
    the sparse plan (B1 carries every int8 combine): each fleet's rows'
    link and per-agent counts, n_active and joules equal the host replay
    round by round, and the summed joules the replayed bill (``==``); B1
    launches 5 × 12 × 1 leaf."""
    import numpy as np
    from repro_torch.core import topology
    from repro_torch.launch import async_fleet
    from repro_torch.rl.casestudy import delivered_comm_joules

    K, R = async_fleet.K, async_fleet.ROUNDS
    stacked = async_fleet.fleet_params(DEVICE)
    zero_counts()
    fleets = async_fleet.processes()
    for label, agents in fleets:
        eng, mixed, tel = async_fleet.run(agents, label, stacked,
                                          plan="sparse")
        if eng.plan.kind != "sparse" or not torch.isfinite(mixed["w"]).all():
            fail(f"fleet {label!r}: plan {eng.plan.kind}, params not finite")
        topo = eng.topology
        acts = topology.availability_stream(agents, K, R)
        masks = [topo.adjacency & a[:, None] & a[None, :] for a in acts]
        ev = tel.events(driver="consensus")
        lc = np.asarray(topo.link_class)
        for e, m, a in zip(ev, masks, acts):
            if e["n_active"] != int(a.sum()):
                fail(f"fleet {label!r} round {e['round']}: n_active "
                     f"{e['n_active']} != replay {int(a.sum())}")
            for cls, code in (("sl", topology.SL), ("ul", topology.UL),
                              ("dl", topology.DL)):
                hit = m & (lc == code)
                if e[f"n_{cls}"] != int(hit.sum()) or \
                        e[f"agent_{cls}"] != hit.sum(0).tolist():
                    fail(f"fleet {label!r} round {e['round']} {cls}: row "
                         "counts differ from the host replay")
        # each round's row against that round's replayed bill, and the
        # ledger's sum against the same sum of the replayed bills (Python
        # 3.12's sum() is compensated; a left-to-right += of 12 × 44.8 J
        # lands one ulp away)
        bills = [delivered_comm_joules(topo, [m], tel.energy_params,
                                       eng.codec) for m in masks]
        if len(ev) != R or [e["joules"] for e in ev] != bills or \
                tel.joules(driver="consensus") != sum(bills):
            fail(f"fleet {label!r}: {len(ev)} rows, joules "
                 f"{[e['joules'] for e in ev]} (sum "
                 f"{tel.joules(driver='consensus')}) != replay {bills}")
    got = launch_counts()
    want = {n: len(fleets) * R if n == "quant_consensus_pop" else 0
            for n in KERNELS}
    print(f"(d) {len(fleets)} fleets x {R} rounds, int8 sparse: rows == host "
          f"replay, joules == bill; launches {got} (expected {want})",
          flush=True)
    if got != want:
        fail(f"fleets launched {got}, expected {want}")
    return {"paper_fleet_int8": got}


def trace_kernels(prof, name):
    """Export ``prof``'s trace to ``build/profile/<name>.json`` beside the
    kernels; return its path and its device-kernel events."""
    from repro_torch.kernels import build
    out = build.BUILD_ROOT.parent / "profile" / f"{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    return out, [e for e in events if e.get("cat") == "kernel"]


def top_kernels(kernels, per, n=6):
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0) + e.get("dur", 0)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]:
        print(f"  {us / per / 1e3:.4f} ms  {name[:90]}", flush=True)


def profile_round(rounds=3):
    """Where one case-study FL round spends its time (int8 wire, sparse
    plan): host wall per round without the profiler, then device kernel
    time per round from a ``torch.profiler`` trace of the same rounds.
    The trace goes to ``build/profile/`` beside the kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.rl.casestudy import CaseStudy

    cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                   codec="int8", device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    C = cs.network.devices_per_cluster
    stacked = {k: v.unsqueeze(0).expand((C,) + v.shape).clone()
               for k, v in cs.init_params(gen).items()}
    state = cs.engine.init_state(stacked)

    def run():
        nonlocal stacked, state
        for _ in range(rounds):
            stacked, state, _ = cs.fl_round(0, stacked, state, gen)
        torch.cuda.synchronize()

    run()                                            # warm-up
    t = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t) / rounds * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    out, kernels = trace_kernels(prof, "casestudy_fl_round")
    busy_ms = sum(e.get("dur", 0) for e in kernels) / rounds / 1e3
    cons_ms = sum(e.get("dur", 0) for e in kernels
                  if "consensus_pop_kernel" in e.get("name", "")
                  ) / rounds / 1e3
    print(f"FL round (2 robots, int8, sparse): wall_ms={wall_ms} "
          f"kernels_per_round={len(kernels) / rounds} "
          f"device_busy_ms={busy_ms} busy_share={busy_ms / wall_ms} "
          f"consensus_kernels_ms={cons_ms} (trace {out})", flush=True)
    if not kernels:
        print("profiler trace holds no device kernels: device time "
              "not measured", flush=True)
        return
    top_kernels(kernels, rounds)


def visible_pairs(S, T, causal, window):
    """(query, key) pairs the masks leave visible, positions from 0."""
    q = torch.arange(S, dtype=torch.int64)
    hi = torch.minimum(q, torch.tensor(T - 1)) if causal else \
        torch.full_like(q, T - 1)
    lo = (q - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def check_lm_kernels(cfg, generator):
    """B3 and B4 against their plain versions on the card at the serving
    shapes, then their times and bounds there."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    Bs, S = SERVE["batch"], SERVE["prompt_len"]
    W, H, K, hd = (cfg.rglru.lru_width, cfg.num_heads, cfg.num_kv_heads,
                   cfg.head_dim_)
    window, softcap = cfg.sliding_window, cfg.logit_softcap

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=generator, device=DEVICE).to(dtype)

    # B3 at the prefill's shape: f32 (B, T, W), decays like the model's
    log_a = -8.0 * F.softplus(randn(W) - 6.0) * torch.sigmoid(randn(Bs, S, W))
    b = randn(Bs, S, W)
    h0 = randn(Bs, W)
    h, hl = ops.rglru_scan(log_a, b, h0)
    wh, whl = ref.rglru_scan_reference(log_a, b, h0)
    torch.cuda.synchronize()
    b3_abs = max(float((h - wh).abs().max()), float((hl - whl).abs().max()))
    b3_rel = max(float(((h - wh).abs() / wh.abs().clamp(min=1)).max()),
                 float(((hl - whl).abs() / whl.abs().clamp(min=1)).max()))
    print(f"rglru_scan ({Bs}, {S}, {W}) f32 with h0: max |kernel - plain| = "
          f"{b3_abs}, max |d|/max(1,|plain|) = {b3_rel} (gate {B3_TOL})",
          flush=True)
    if not torch.isfinite(h).all() or b3_rel > B3_TOL:
        fail(f"rglru_scan: {b3_rel} > {B3_TOL}")

    # B4 at the serving shape (B = 1 for the plain version's O(S·T)
    # scores) in bf16: randn q gives scores of std 1, q x 20 scores of std
    # 20 that the softcap bends; a ragged bf16 case (S, T not tile
    # multiples, hd 120, a window whose edge cuts kv tiles); and a ragged
    # f32 case
    b4_err = 0.0
    for dtype, qscale, (B, Sq, Hq, Kq, d, win, cap) in (
            (torch.bfloat16, 1.0, (1, S, H, K, hd, window, softcap)),
            (torch.bfloat16, 20.0, (1, S, H, K, hd, window, softcap)),
            (torch.bfloat16, 1.0, (1, 1000, 8, 2, 120, 300, softcap)),
            (torch.float32, 1.0, (1, 1000, 8, 2, 120, 0, 0.0))):
        q, k, v = (randn(B, Sq, n, d, dtype=dtype) for n in (Hq, Kq, Kq))
        q = (q.float() * qscale).to(dtype)
        kw = dict(causal=True, window=win, softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_reference(q, k, v, **kw)
        diff = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            pv = ref.attention_reference(q.float(), k.float(),
                                         v.float().abs(), **kw)
            gate = (B4_BF16_REL * want.float().abs() + B4_BF16_PV * pv
                    + B4_BF16_ABS)
            rms = float(want.float().square().mean().sqrt())
            what = (f"2^-7 |plain| + 2^-8 P|v| + {B4_BF16_ABS} gate; typical "
                    f"|plain| (rms) {rms}")
            del pv
        else:
            gate = B4_F32_TOL + B4_F32_TOL * want.float().abs()
            what = f"{B4_F32_TOL} abs+rel gate"
        torch.cuda.synchronize()
        worst = float((diff / gate).max())
        err = float(diff.max())
        b4_err = max(b4_err, err)
        print(f"flash_attention {tuple(q.shape)} kv {tuple(k.shape)} {dtype} "
              f"q x {qscale} window={win} softcap={cap}: max |kernel - plain| "
              f"= {err}, {worst:.4g} of the {what}", flush=True)
        if not torch.isfinite(got.float()).all() or worst > 1.0:
            fail(f"flash_attention {dtype} q x {qscale}: beyond its gate")
        del q, k, v, got, want, diff, gate

    rows = {}
    # B3 times: inputs read once (2 x 4 B), output written (4 B) per
    # element, h0 and h_last rows; exp + mul + add per element
    n = Bs * S * W
    b3 = bound(12 * n + 8 * Bs * W, 3 * n)
    t3 = (median_ms(lambda: ops.rglru_scan(log_a, b, h0)),
          median_ms(lambda: ref.rglru_scan_reference(log_a, b, h0)))
    print(f"rglru_scan ({Bs}, {S}, {W}) f32: kernel_ms={t3[0]} plain_ms="
          f"{t3[1]} library_ms=None bound_ms={b3[0]} ({b3[1]})", flush=True)
    rows["rglru_scan"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:46", max_abs_err=b3_abs,
        ms=t3[0], plain_ms=t3[1], bound_ms=b3[0], bound_by=b3[1],
        library_ms=None)
    del log_a, b, h0, h, hl, wh, whl

    # B4 times at the serving shape, bf16: q, k, v read and out written
    # once; 4·hd flops per visible (query, key) pair per (batch, q head)
    q, k, v = (randn(Bs, S, n_, hd, dtype=torch.bfloat16) for n_ in (H, K, K))
    pairs = visible_pairs(S, S, True, window)
    flops = 4 * hd * pairs * Bs * H
    b4 = bound(2 * (2 * q.numel() + k.numel() + v.numel()), flops,
               BF16_FLOPS_PER_S)
    kw = dict(causal=True, window=window, softcap=softcap)
    t_kernel = median_ms(lambda: ops.flash_attention(q, k, v, **kw))
    t_cap0 = median_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                   window=window))
    t_plain = median_ms(lambda: ref.attention_reference(q, k, v, **kw))
    # library yardstick: SDPA at softcap 0 with the same causal + window
    # boolean mask (kv heads expanded for MQA); never called by the port
    pos = torch.arange(S, device=DEVICE)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qt = q.transpose(1, 2)
    kt, vt = (t.transpose(1, 2).expand(Bs, H, S, hd) for t in (k, v))
    t_lib = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    print(f"flash_attention q {tuple(q.shape)} kv {tuple(k.shape)} bf16 "
          f"window={window} softcap={softcap}: kernel_ms={t_kernel} "
          f"(softcap 0: {t_cap0}) plain_ms={t_plain} library_ms(SDPA, "
          f"softcap 0)={t_lib} bound_ms={b4[0]} ({b4[1]}); visible pairs "
          f"per (b, h) {pairs}; achieved {flops / t_kernel / 1e9} TFLOP/s "
          f"(softcap 0: {flops / t_cap0 / 1e9}) against the bound's "
          f"{BF16_FLOPS_PER_S / 1e12}", flush=True)
    for name in ("rglru_scan", "flash_attention"):
        print(f"ptxas {name}.cu: {ptxas_summary(name)}", flush=True)
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98", max_abs_err=b4_err,
        ms=t_kernel, plain_ms=t_plain, bound_ms=b4[0], bound_by=b4[1],
        library_ms=t_lib)
    return rows


def run_serve(cfg):
    """The serving entry point at full size, counted from 0: each prefill
    launches B3 once per recurrent layer and B4 once per attention layer,
    decode neither, and the consensus kernels never."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import rglru

    types = rglru.layer_types(cfg)
    want = {n: 0 for n in KERNELS}
    want_prefill = dict(want, rglru_scan=types.count("recurrent"),
                        flash_attention=types.count("attention"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t = time.perf_counter()
    res = serve(cfg, seed=0, device=DEVICE, verbose=True, **SERVE)
    wall = time.perf_counter() - t
    got = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve {ARCH} batch={SERVE['batch']} prompt={SERVE['prompt_len']} "
          f"gen={SERVE['gen']}: prefill_ms={res.prefill_ms} "
          f"decode_ms_per_token={res.decode_ms_per_token} "
          f"peak_memory_GB={peak_gb} wall_s(init included)={wall} "
          f"launches={got} by phase {res.launches}", flush=True)
    if got != want_prefill:
        fail(f"serve launched {got}, expected {want_prefill}")
    if res.launches["prefill"] != {n: want_prefill[n] for n in
                                   res.launches["prefill"]} \
            or any(res.launches["decode"].values()):
        fail(f"serve launches by phase {res.launches}")
    tok = res.tokens
    if tuple(tok.shape) != (SERVE["batch"], SERVE["gen"]) or not bool(
            ((tok >= 0) & (tok < cfg.vocab_size)).all()):
        fail(f"tokens out of range or shape {tuple(tok.shape)}")
    if not torch.isfinite(res.last_logits.float()).all():
        fail("last-position prefill logits are not finite")
    print(f"tokens[0]={tok[0].tolist()}", flush=True)
    return got


@torch.no_grad()
def profile_serve(cfg, steps=4):
    """Where the serving time goes, at full size: host wall, kernels
    launched and device kernel time of one prefill and of ``steps``
    decode steps, from ``torch.profiler`` traces (after a warm prefill).
    B3/B4's share of the prefill's device time is read from the trace."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import rglru

    B, S = SERVE["batch"], SERVE["prompt_len"]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    model = rglru.cast_for_serving(
        rglru.init(cfg, generator=gen, device=DEVICE), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEVICE)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def run_prefill():
        caches = rglru.init_cache(cfg, B, S + steps + 1, device=DEVICE)
        last, caches = prefill(model, caches, {"tokens": prompts})
        torch.cuda.synchronize()
        return torch.argmax(last[:, -1], -1).to(torch.int32)[:, None], caches

    def run_decode(nxt, caches):
        for i in range(steps):
            nxt, caches = decode(model, caches, {"tokens": nxt,
                                                 "cache_index": S + i})
        torch.cuda.synchronize()

    nxt, caches = run_prefill()                       # warm-up
    run_decode(nxt, caches)
    t = time.perf_counter()
    nxt, caches = run_prefill()
    wall_p = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    run_decode(nxt, caches)
    wall_d = (time.perf_counter() - t) * 1e3 / steps
    with profile(activities=acts) as prof:
        nxt, caches = run_prefill()
    _, kp = trace_kernels(prof, "serve_prefill")
    with profile(activities=acts) as prof:
        run_decode(nxt, caches)
    _, kd = trace_kernels(prof, "serve_decode")
    if not kp or not kd:
        print("profiler trace holds no device kernels: device time not "
              "measured", flush=True)
        return
    busy_p = sum(e.get("dur", 0) for e in kp) / 1e3
    b3 = sum(e.get("dur", 0) for e in kp if "rglru_scan_kernel" in e["name"]) / 1e3
    b4 = sum(e.get("dur", 0) for e in kp
             if "flash_attention_kernel" in e["name"]) / 1e3
    busy_d = sum(e.get("dur", 0) for e in kd) / 1e3 / steps
    print(f"prefill {B}x{S}: wall_ms={wall_p} kernels={len(kp)} "
          f"device_busy_ms={busy_p} busy_share={busy_p / wall_p} "
          f"rglru_scan_ms={b3} ({b3 / busy_p:.4f} of device time) "
          f"flash_attention_ms={b4} ({b4 / busy_p:.4f})", flush=True)
    top_kernels(kp, 1)
    print(f"decode step (batch {B}): wall_ms={wall_d} kernels_per_step="
          f"{len(kd) / steps} device_busy_ms={busy_d} busy_share="
          f"{busy_d / wall_d}", flush=True)
    top_kernels(kd, steps)


@torch.no_grad()
def check_decode_vs_forward(cfg, batch=2, prompt=2100):
    """Full width, one pattern period (3 layers): prefill + 1 decode step
    through the caches equals the full forward at the last position
    (prompt longer than the window, so the circular cache wraps)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import rglru

    cfg3 = dataclasses.replace(cfg, num_layers=len(cfg.rglru.block_pattern))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    model = rglru.cast_for_serving(
        rglru.init(cfg3, generator=gen, device=DEVICE), cfg3)
    toks = torch.randint(0, cfg3.vocab_size, (batch, prompt), generator=gen,
                         device=DEVICE)
    caches = rglru.init_cache(cfg3, batch, prompt + 1, device=DEVICE)
    zero_counts()
    last, caches = make_prefill_step(cfg3)(model, caches, {"tokens": toks})
    nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    prefill_counts = launch_counts()
    zero_counts()
    step, _, _ = rglru.forward(model, cfg3, nxt, caches=caches,
                               cache_index=prompt)
    make_decode_step(cfg3)(model, caches, {"tokens": nxt,
                                           "cache_index": prompt})
    decode_counts = launch_counts()
    full, _, _ = rglru.forward(model, cfg3, torch.cat([toks, nxt], 1),
                               last_only=True)
    torch.cuda.synchronize()
    a, b = step[:, -1].float(), full[:, -1].float()
    worst = float(((a - b).abs() / (DECODE_TOL + DECODE_TOL * b.abs())).max())
    print(f"decode vs full forward ({cfg3.num_layers} layers, width "
          f"{cfg3.d_model}, prompt {prompt}): max |d| = "
          f"{float((a - b).abs().max())}, {worst:.4g} of the {DECODE_TOL} "
          f"abs+rel gate; launches prefill {prefill_counts} decode "
          f"{decode_counts}", flush=True)
    if not torch.isfinite(a).all() or worst > 1.0:
        fail("decode step disagrees with the full forward")
    if any(decode_counts.values()) or prefill_counts["rglru_scan"] != 2 \
            or prefill_counts["flash_attention"] != 1:
        fail(f"3-layer launches prefill {prefill_counts} decode "
             f"{decode_counts}")


def main():
    phase("env")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs only on the card", file=sys.stderr)
        sys.exit(3)
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        fail(f"{src / 'repro_torch'} is missing: run this script from the "
             "root of a checkout of the repository")
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build

    repro_torch.set_f32_matmul()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    phase("build")
    secs = build.build()
    for name in build.BUILD_LOGS:
        print(f"{name}: {ptxas_summary(name)}", flush=True)
    print(f"built in {secs:.1f} s ({os.fspath(build.BUILD_ROOT)})", flush=True)

    phase("kernels")
    cfg = get_arch("paper-dqn")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    pops, errs = check_kernels(cfg, gen)
    rows = time_kernels(pops, errs)

    phase("engine")
    check_engine(pops)

    phase("casestudy")
    by_path, walls = run_casestudy()

    phase("dynamic")
    check_dynamic_engine(pops)
    stamp("engine checks")
    check_dynamic_masks()
    check_dynamic_kernels(pops, errs)
    for name in errs:
        rows[name]["max_abs_err"] = errs[name]
    stamp("mask and kernel checks")
    dyn_paths, dyn_walls, dyn_int8 = run_dynamic_casestudy()
    by_path.update(dyn_paths)
    # the static int8 run is the script's first case study and carries its
    # warm-up; the codec=None pair are both warm
    print("dynamic / static case-study wall: " + ", ".join(
        f"codec={spec}: {dyn_walls[spec]} / {walls[spec]} = "
        f"{dyn_walls[spec] / walls[spec]}" for spec in walls) +
        " (static int8 is the first run: warm-up included)", flush=True)
    stamp("dynamic case study")
    profile_dynamic_round()

    phase("drivers")
    x = pops[K_POP]
    for path, label, fn, args in (
            ("drivers_scan_rounds_int8", "(a) scan_rounds telemetry",
             check_scan_rounds_telemetry, (x,)),
            ("drivers_fl_f32", "(b) FL drivers", check_fl_drivers, (x,)),
            ("drivers_casestudy_streaming_int8", "(c) streaming case study",
             run_streaming_casestudy, (dyn_int8,)),
            ("drivers_protocol", "(d) MTLProtocol", run_protocol, ())):
        t = time.perf_counter()
        by_path[path] = fn(*args)
        print(f"{label}: {time.perf_counter() - t:.2f} s", flush=True)
    del pops, x, dyn_int8
    torch.cuda.empty_cache()

    phase("paper")
    for label, fn in (("(a) C1", check_paper_c1),
                      ("(b) sweep", check_paper_sweep),
                      ("(c) meta round", measure_meta_round),
                      ("(d) async fleet", check_fleet)):
        t = time.perf_counter()
        by_path.update(fn())
        print(f"{label}: {time.perf_counter() - t:.2f} s", flush=True)

    phase("profile")
    profile_round()

    phase("lm_kernels")
    lm_cfg = get_arch(ARCH)
    rows.update(check_lm_kernels(lm_cfg, gen))
    torch.cuda.empty_cache()

    phase("serve")
    by_path["serve"] = run_serve(lm_cfg)
    torch.cuda.empty_cache()
    profile_serve(lm_cfg)
    torch.cuda.empty_cache()
    check_decode_vs_forward(lm_cfg)

    # launches: the sum over the main paths (the case study's runs, the
    # drivers' runs, the paper's runs, the serving run), each counted from
    # 0 in its own run;
    # launches_by_path keeps them apart
    kernels = [dict(name=n, launches=sum(p[n] for p in by_path.values()),
                    launches_by_path={k: p[n] for k, p in by_path.items()},
                    **rows[n]) for n in KERNELS]
    print(f"all phases done at t = {time.perf_counter() - T_START:.1f} s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
