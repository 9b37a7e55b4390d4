"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Phases (any failure exits non-zero; nothing is caught):

1. env        — torch/CUDA versions, the card's name and power limit.
2. build      — compile both CUDA kernels from ``src/repro_torch/kernels/
                csrc`` (one nvcc per source, in parallel), timed as set-up.
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
6. profile    — host wall and device kernel time of one case-study FL
                round (``torch.profiler``), the device's busy share.

The line before the last is the kernels JSON; the last is the ``ok`` line.

Run:  python3 chip_smoke.py
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside tensor cores
F32_TOL = 1e-6                  # kernel vs plain: same ops, same order
BF16_TOL = 0.0                  # ... and the same final rounding
K_POP = 256
DEVICE = "cuda"


def phase(name):
    print(f"\n== {name} ==", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    """(least time in ms, what bounds it) for the given bytes and flops."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


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
        t_b2 = (time_ms(lambda: ops.consensus_update_pop(xf, idx, sig)),
                time_ms(lambda: ref.consensus_update_pop_reference(xf, idx, sig)),
                time_ms(lambda: M @ xf))
        c = codecs.get_codec("int8")
        enc = c.encode_leaf(xf)
        q, s = enc["q"], enc["scale"]
        # bytes: x, out (4 + 4), int8 lanes (1) per element, scales, lanes;
        # flops: dequant, sub, mul, add per neighbour, own dequant, x + acc
        b1 = bound(9 * K * N + 4 * K + 8 * K * H, 4 * K * N * H + 2 * K * N)
        t_b1 = (time_ms(lambda: ops.quant_consensus_pop(xf, q, s, idx, sig)),
                time_ms(lambda: ref.quant_consensus_pop_reference(
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
    from repro_torch.kernels import ops
    from repro_torch.rl.casestudy import CaseStudy

    t0, max_rounds = 4, 8
    own = {"int8": "quant_consensus_pop", None: "consensus_update_pop"}
    by_path = {}
    for spec in ("int8", None):
        cs = CaseStudy(plan="sparse-pallas", inner_steps=10, outer_lr=0.01,
                       codec=spec, device=DEVICE)
        if cs.engine.plan.kind != "sparse":
            fail(f"case study engine resolved to {cs.engine.plan.kind!r}")
        leaves = len(cs.init_params(torch.Generator(device=DEVICE)))
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        ops.consensus_update_pop.launches = 0
        ops.quant_consensus_pop.launches = 0
        t = time.perf_counter()
        res = cs.run(gen, t0, max_rounds=max_rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {"consensus_update_pop": ops.consensus_update_pop.launches,
               "quant_consensus_pop": ops.quant_consensus_pop.launches}
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
    return by_path


def profile_round(rounds=3):
    """Where one case-study FL round spends its time (int8 wire, sparse
    plan): host wall per round without the profiler, then device kernel
    time per round from a ``torch.profiler`` trace of the same rounds.
    The trace goes to ``build/profile/`` beside the kernels."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
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
    out = build.BUILD_ROOT.parent / "profile" / "casestudy_fl_round.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
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
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0) + e.get("dur", 0)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {us / rounds / 1e3:.4f} ms/round  {name[:90]}", flush=True)


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
    for name, log in build.BUILD_LOGS.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(info)}", flush=True)
    print(f"built in {secs:.1f} s ({os.fspath(build.BUILD_ROOT)})", flush=True)

    phase("kernels")
    cfg = get_arch("paper-dqn")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    pops, errs = check_kernels(cfg, gen)
    rows = time_kernels(pops, errs)

    phase("engine")
    check_engine(pops)
    del pops
    torch.cuda.empty_cache()

    phase("casestudy")
    by_path = run_casestudy()

    phase("profile")
    profile_round()

    # launches: the sum over the case study's two paths, each counted from
    # 0 in its own run; launches_by_path keeps them apart
    kernels = [dict(name=n, launches=sum(p[n] for p in by_path.values()),
                    launches_by_path={k: p[n] for k, p in by_path.items()},
                    **rows[n]) for n in rows]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
