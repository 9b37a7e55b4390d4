"""Benchmark harness of the port: the twin of the JAX package's
``benchmarks/run.py``, section for section.

One function per paper table or figure, and the kernel and protocol
microbenchmarks. Prints ``name,us_per_call,derived`` CSV rows (derived =
the quantity the paper's table reports, e.g. kJ or a ratio; blank when
N/A) and writes them to ``RESULTS/bench.csv``.

* ``bench_kernels`` — each of the reference's kernel rows, and the port's
  other kernels at the same shapes, as a ``plain`` row (the kernel's plain
  PyTorch version, ``kernels/ref.py``: the counterpart of the reference's
  ``xla`` oracle path) and, on the card, a ``cuda`` row (the hand-written
  kernel through its ``kernels/ops.py`` wrapper, whose launch counter must
  rise by exactly one a call); on the card also one ``cuda.main`` row per
  kernel at the main path's shape, whose ``derived`` holds the call's
  device time alone (``kernels/timing.py``: none of the wrapper's host
  work) and the share of its H100 bound (``kernels/work.py``) that time
  reaches.
* ``bench_protocol`` — one MAML round and one FL round of the case study
  at full paper-DQN width, each a replay of the round program the case
  study holds (a CUDA graph on the card), and each again under
  ``scanloop.uncaptured()`` (eager).
* ``bench_fig3``, ``bench_fig4``, ``bench_table2`` — read the sweep's JSON
  (``python -m repro_torch.rl.fig4_tradeoff``) if it exists, else price
  the paper's published Table II rounds.
* ``bench_roofline`` — the dry run's H100 roofline
  (``python -m repro_torch.launch.dryrun --all --out ...``), if it exists.

Run: ``PYTHONPATH=src python -m repro_torch.launch.run [--device cuda|cpu]``.
On ``--device cpu`` only the ``plain`` and protocol rows run (the wrappers
send CPU tensors to the plain versions, so a ``cuda`` row there would time
the plain version); ``--device cuda`` without a card exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

RESULTS = "build/results"
ROWS = []
#: the sweep's JSON, as ``rl/fig4_tradeoff.py`` names it under RESULTS
FIG4 = "torch_fig4.json"


def row(name: str, us_per_call: float, derived: str = ""):
    ROWS.append((name, us_per_call, derived))
    print(f"{name},{us_per_call:.1f},{derived}")


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _time(fn, *args, reps=5, warmup=2):
    for _ in range(warmup):
        fn(*args)
        _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / reps * 1e6


def _time_launches(wrapper, fn, *, reps, warmup):
    """:func:`_time` of ``fn``, which must launch ``wrapper``'s kernel once
    a call: its counter must rise by exactly ``reps + warmup``."""
    before = wrapper.launches
    us = _time(fn, reps=reps, warmup=warmup)
    got = wrapper.launches - before
    if got != reps + warmup:
        raise RuntimeError(
            f"{wrapper.__name__}: {got} launches in {reps + warmup} calls; a "
            "cuda row must launch its kernel once a call")
    return us


# ---------------------------------------------------------------------------
# kernel microbenchmarks: the plain versions (the reference's XLA oracle
# path) and, on the card, the hand-written kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCase:
    """One kernel row, ``kernel.<name>.<plain|cuda>.<size>``: the op's
    inputs by name and shape (the reference's names and shapes where it
    has the row), keywords and dtype. ``sig`` is the reference's constant
    [0.3, 0.3]; every other input is drawn from N(0, 1) (``log_a`` as
    −softplus of a draw). Consensus rows with ``nb`` are the reference's
    one agent and its two neighbour rows; without, a population that
    mixes over ``ring(K)``."""
    name: str
    op: str
    size: str
    shapes: dict
    kw: dict = dataclasses.field(default_factory=dict)
    dtype: torch.dtype = torch.float32


#: op -> (wrapper in ``kernels/ops.py``, plain version in ``kernels/ref.py``)
OPS = {
    "flash_attention": ("flash_attention", "attention_reference"),
    "rglru_scan": ("rglru_scan", "rglru_scan_reference"),
    "consensus_update": ("consensus_update_pop",
                         "consensus_update_pop_reference"),
    "quant_consensus": ("quant_consensus_pop", "quant_consensus_pop_reference"),
    "rglru_scan_backward": ("rglru_scan_backward",
                            "rglru_scan_backward_reference"),
    "flash_attention_backward": ("flash_attention_backward",
                                 "attention_backward_reference"),
}

_QKV = dict(q=(2, 512, 8, 64), k=(2, 512, 2, 64), v=(2, 512, 2, 64))
_SCAN = dict(log_a=(4, 1024, 256), b=(4, 1024, 256))
_AGENT = dict(x=(1_000_000,), nb=(2, 1_000_000), sig=(2,))
#: the reference's five rows (``benchmarks/run.py:48-76``; its
#: ``interpret.128`` row is the kernel at its shapes), then the port's
#: other kernels at their shapes
KERNEL_CASES = (
    KernelCase("flash_attention", "flash_attention", "512", _QKV),
    KernelCase("flash_attention.swa", "flash_attention", "512", _QKV,
               dict(window=128)),
    KernelCase("flash_attention", "flash_attention", "128",
               dict(q=(1, 128, 4, 64), k=(1, 128, 2, 64), v=(1, 128, 2, 64))),
    KernelCase("rglru_scan", "rglru_scan", "1024", _SCAN),
    KernelCase("consensus_update", "consensus_update", "1M", _AGENT),
    KernelCase("quant_consensus", "quant_consensus", "1M", _AGENT),
    KernelCase("rglru_scan_backward", "rglru_scan_backward", "1024",
               dict(_SCAN, g_h=(4, 1024, 256), g_last=(4, 256))),
    KernelCase("flash_attention_backward", "flash_attention_backward", "512",
               dict(_QKV, g=(2, 512, 8, 64))),
)
#: the main path's shape of each kernel (PERF.md's kernel table): B1/B2 at
#: paper-DQN's fc1.w over K = 256 on a ring, B3 at recurrentgemma-9b's
#: prefill, B4 at its local attention's, B3′ at the hybrid's training
#: shape from zero, B4′ at granite-8b's
MAIN_CASES = (
    KernelCase("quant_consensus", "quant_consensus", "main",
               dict(x=(256, 262_144))),
    KernelCase("consensus_update", "consensus_update", "main",
               dict(x=(256, 262_144))),
    KernelCase("rglru_scan", "rglru_scan", "main",
               dict(log_a=(4, 4096, 4096), b=(4, 4096, 4096), h0=(4, 4096))),
    KernelCase("flash_attention", "flash_attention", "main",
               dict(q=(4, 4096, 16, 256), k=(4, 4096, 1, 256),
                    v=(4, 4096, 1, 256)),
               dict(causal=True, window=2048, softcap=30.0), torch.bfloat16),
    KernelCase("rglru_scan_backward", "rglru_scan_backward", "main",
               dict(log_a=(2, 512, 4096), b=(2, 512, 4096),
                    g_h=(2, 512, 4096), g_last=(2, 4096))),
    KernelCase("flash_attention_backward", "flash_attention_backward", "main",
               dict(q=(4, 512, 32, 128), k=(4, 512, 8, 128),
                    v=(4, 512, 8, 128), g=(4, 512, 32, 128)),
               dict(causal=True), torch.bfloat16),
)


def kernel_inputs(case: KernelCase, device):
    """``(args, kwargs)`` of ``case``'s wrapper and plain version, drawn
    from seed 0 by a generator on ``device``."""
    import torch.nn.functional as F
    from repro_torch.core import consensus, topology
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(0)
    t = {n: torch.randn(s, generator=gen, device=device)
         for n, s in case.shapes.items() if n != "sig"}
    if "log_a" in t:
        t["log_a"] = -F.softplus(t["log_a"])
    if case.op in ("flash_attention", "flash_attention_backward"):
        return tuple(x.to(case.dtype) for x in t.values()), dict(case.kw)
    if case.op == "rglru_scan":
        return (t["log_a"], t["b"], t.get("h0")), {}
    if case.op == "rglru_scan_backward":
        h, _ = ref.rglru_scan_reference(t["log_a"], t["b"])
        return (t["log_a"], t["b"], None, h, t["g_h"], t["g_last"]), {}
    if "nb" in t:
        x, src = t["x"][None], t["nb"]
        idx = torch.tensor([[0, 1]], dtype=torch.int32, device=device)
        sig = torch.full((1, 2), 0.3, device=device)
    else:
        x, src = t["x"], None
        idx, sig = (torch.as_tensor(a, device=device) for a in
                    consensus.sparse_structure(
                        topology.ring(x.shape[0]).mixing()))
    if case.op == "consensus_update":
        return (x, idx, sig, src), {}
    # an int8 wire, one absmax scale a row (the reference's neighbours'
    # rows on theirs), rounded to the nearest lane
    rows = x if src is None else torch.cat([x, src])
    s = rows.abs().amax(dim=1) / 127
    q = torch.round(rows / s[:, None]).to(torch.int8)
    if src is None:
        return (x, q, s, idx, sig), {}
    return (x, q[:1], s[:1], idx, sig, None, q[1:], s[1:]), {}


def _bound_ms(case: KernelCase, args, kw):
    """(least ms on an H100 SXM, what bounds it) for the case's work
    (``kernels/work.py``: its counts and :func:`work.bound_ms`)."""
    from repro_torch.kernels import work

    op, a0 = case.op, args[0]
    elem = a0.element_size()
    if op == "consensus_update":
        counts = work.consensus_update_pop(*a0.shape, args[1].shape[1], elem)
    elif op == "quant_consensus":
        counts = work.quant_consensus_pop(*a0.shape, args[3].shape[1],
                                          args[2].numel())
    elif op == "rglru_scan":
        counts = work.rglru_scan(*a0.shape, with_h0=args[2] is not None,
                                 elem=elem)
    elif op == "rglru_scan_backward":
        counts = work.rglru_scan_backward(
            *a0.shape, with_h0=args[2] is not None,
            with_g_last=args[5] is not None, elem=elem)
    else:
        B, S, H, hd = a0.shape
        count = (work.flash_attention if op == "flash_attention"
                 else work.flash_attention_backward)
        counts = count(B, S, args[1].shape[1], H, args[1].shape[2], hd,
                       causal=kw.get("causal", True),
                       window=kw.get("window", 0), elem=elem)
    return work.bound_ms(*counts, bf16=a0.dtype == torch.bfloat16)


def bench_kernels(device="cuda", reps=5, warmup=2):
    from repro_torch.kernels import build, ops, ref, timing

    cuda = torch.device(device).type == "cuda"
    if cuda:
        build.build()          # every kernel, in parallel, before any timing
    for case in KERNEL_CASES + (MAIN_CASES if cuda else ()):
        wrapper_name, plain_name = OPS[case.op]
        wrapper, plain = getattr(ops, wrapper_name), getattr(ref, plain_name)
        args, kw = kernel_inputs(case, device)
        if case.size != "main":
            us = _time(lambda: plain(*args, **kw), reps=reps, warmup=warmup)
            row(f"kernel.{case.name}.plain.{case.size}", us)
        if not cuda:
            continue
        us = _time_launches(wrapper, lambda: wrapper(*args, **kw), reps=reps,
                            warmup=warmup)
        derived = ""
        if case.size == "main":
            dev = timing.device_ms(lambda: wrapper(*args, **kw))
            bound, by = _bound_ms(case, args, kw)
            derived = (f"device_ms={dev:.4f};bound_ms={bound:.4f}({by});"
                       f"share={bound / dev:.3f}")
        row(f"kernel.{case.name}.cuda.{case.size}", us, derived)


# ---------------------------------------------------------------------------
# core-protocol microbenchmarks
# ---------------------------------------------------------------------------


def bench_protocol(device="cuda", reps=5, warmup=2):
    from repro_torch.core import scanloop
    from repro_torch.rl.casestudy import CaseStudy

    cs = CaseStudy(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = cs.init_params(gen)
    t = torch.zeros((), dtype=torch.int64, device=device)
    cs.run_meta(gen, params, 0)               # builds the meta program
    meta = [scanloop.own(params)]

    def meta_round():
        (meta[0],), _ = cs._meta_program(meta[0], t, gen, None)

    # task 0's FL round on a 2-robot stack, its carry as the chunked loop
    # (federated.run_chunked_rounds) starts it on a static lockstep engine
    stacked = {k: torch.stack([v, v]) for k, v in params.items()}
    fl = [(stacked, cs.engine.init_state(stacked), None, None,
           torch.zeros((), dtype=torch.bool, device=device))]
    xs = {"t": t, "link": None, "act": None, "batches": None}

    def fl_round():
        (fl[0],), _ = cs._fl_program(0)(fl[0], xs, gen, "eval")

    for name, fn in (("protocol.maml_round.dqn", meta_round),
                     ("protocol.fl_round.dqn", fl_round)):
        row(name, _time(fn, reps=reps, warmup=warmup))
        with scanloop.uncaptured():
            row(f"{name}.uncaptured", _time(fn, reps=reps, warmup=warmup))


# ---------------------------------------------------------------------------
# paper tables/figures
# ---------------------------------------------------------------------------


def bench_fig3():
    from repro_torch.rl.fig3_energy import report
    from repro_torch.rl.fig4_tradeoff import PAPER_TABLE_II as T2
    path = os.path.join(RESULTS, FIG4)
    mr = {}
    if os.path.exists(path):
        with open(path) as f:
            mr = json.load(f)["mean_rounds"]
    r210 = mr.get("210", T2[210])
    r0 = mr.get("0", T2[0])
    src = "measured" if ("210" in mr and "0" in mr) else (
        "partial-measured" if mr else "paper-tableII")
    t0 = time.perf_counter()
    out = report(r210, r0)
    us = (time.perf_counter() - t0) * 1e6
    row(f"fig3.total_maml_kJ.{src}", us, f"{out['total_maml_kJ']:.1f}")
    row(f"fig3.total_fl_only_kJ.{src}", us, f"{out['total_fl_only_kJ']:.1f}")
    row(f"fig3.energy_reduction.{src}", us, f"{out['reduction']:.2f}x")


def bench_fig4():
    from repro_torch.core import energy
    path = os.path.join(RESULTS, FIG4)
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        for regime, r in d["energies"].items():
            row(f"fig4.optimal_t0.{regime}", 0.0, str(r["optimal_t0"]))
        return
    from repro_torch.rl.fig4_tradeoff import PAPER_TABLE_II as T2
    p = energy.paper_calibrated("fig4")
    t0 = time.perf_counter()
    _, _, eb = energy.optimize_split(p, 3, {k: v for k, v in T2.items()
                                            if k})
    us = (time.perf_counter() - t0) * 1e6
    row("fig4.optimal_t0.black_SL500_UL200", us, str(min(eb, key=eb.get)))
    pr = energy.swap_ul_sl(p)
    _, _, er = energy.optimize_split(pr, 3, {k: v for k, v in T2.items()
                                             if k})
    row("fig4.optimal_t0.red_UL500_SL200", us, str(min(er, key=er.get)))


def bench_table2():
    path = os.path.join(RESULTS, FIG4)
    if not os.path.exists(path):
        row("table2.rounds_scaledown", 0.0, "pending(fig4 sweep)")
        return
    with open(path) as f:
        mr = json.load(f)["mean_rounds"]
    s0 = sum(mr["0"])
    best = min((k for k in mr if k != "0"), key=lambda k: sum(mr[k]))
    row("table2.rounds_scaledown", 0.0,
        f"{s0 / max(sum(mr[best]), 1e-9):.1f}x@t0={best}")


def bench_roofline():
    path = os.path.join(RESULTS, "roofline.json")
    if not os.path.exists(path):
        single = os.path.join(RESULTS, "dryrun_single_pod.json")
        if os.path.exists(single):
            from repro_torch.launch.roofline import analyze
            with open(single) as f:
                rows_ = [analyze(r) for r in json.load(f)["reports"]]
            with open(path, "w") as f:
                json.dump(rows_, f, indent=1)
        else:
            row("roofline.pairs", 0.0, "pending(dryrun sweep)")
            return
    with open(path) as f:
        rows_ = json.load(f)
    bounds = {}
    for r in rows_:
        bounds[r["bottleneck"]] = bounds.get(r["bottleneck"], 0) + 1
        row(f"roofline.{r['arch']}.{r['shape']}.step_ms", 0.0,
            f"{r['step_ms']:.2f}({r['bottleneck'][:4]})")
    row("roofline.bottleneck_histogram", 0.0,
        ";".join(f"{k}:{v}" for k, v in sorted(bounds.items())))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"run: --device {args.device} but no CUDA device is "
                         "available; pass --device cpu for the plain rows on "
                         "the CPU")
    import repro_torch
    repro_torch.set_f32_matmul()
    print("name,us_per_call,derived")
    bench_kernels(args.device)
    bench_protocol(args.device)
    bench_fig3()
    bench_fig4()
    bench_table2()
    bench_roofline()
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "bench.csv"), "w") as f:
        f.write("name,us_per_call,derived\n")
        for n, u, d in ROWS:
            f.write(f"{n},{u:.1f},{d}\n")


if __name__ == "__main__":
    main()
