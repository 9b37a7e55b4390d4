"""Variants of the hand-written LM kernels against the shipped ones, on
one CUDA card.

A variant is the repository's own source with named text substitutions
(a constant changed, a term dropped). The script builds each variant with
nvcc (the flags of ``repro_torch.kernels.build``, one process per source,
all started together) and prints ptxas's registers and spills. It then
swaps each variant in behind the port's wrapper
(``repro_torch.kernels.ops``), holds it to the plain version on the same
seeded inputs, and times it at recurrentgemma-9b's prefill shapes (median
of 20 calls, CUDA events).

  python3 tools/kernel_variants.py rglru 64,16,3 64,32,5
      RG-LRU scan ring shapes (channels per block, steps per tile, ring
      depth) at (4, 4096, 4096) f32; each must equal the plain version
      bit for bit.
  python3 tools/kernel_variants.py rglru_bwd 64,64,8 32,64,8 64,64,8,no_wait
      B3' (the scan's backward) launch shapes (channels a CTA, steps a
      chunk, CTAs a cluster; above 8 non-portable; then any diagnostics
      of RGLRU_BWD below, which give wrong results) at the hybrid's
      training shape (2, 512, 4096) from zero with g_last, f32 reading
      the saved output and bf16; each must equal the plain version bit
      for bit; the events' time and the device time alone (profiler)
      with the L2 evicted before each call (a 128 MB read).
  python3 tools/kernel_variants.py attention
      The flash-attention variants in ATTENTION below, at q (4, 4096, 16,
      256), k/v (4, 4096, 1, 256) bf16, window 2048, softcap 30; the
      share of chip_smoke.py's bf16 rounding gate at q x 1 and q x 20
      (batch 1, as there).
  python3 tools/kernel_variants.py backward
      The bf16 attention-backward variants in BACKWARD below (P or dS as
      hi + lo bf16 terms) at chip_smoke.py's seven training shapes, q x 1
      and q x 20: each gradient's max |d| over its largest entry as a
      share of the smoke's gates (2^-7 against the plain backward, 2 x
      2^-7 against autograd through the plain forward), and the time at
      q x 1.

It exits non-zero without a CUDA card, and if a build fails.
"""
import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_variants"

# the shipped wait loop, and the same loop with a watchdog trap
_WAIT = "  uint32_t done;\n  do {"
_WAIT_END = "  } while (!done);"
ATTENTION = {
    "shipped": [],
    # P rounded once to bf16, as FlashAttention-3 does: the P_lo product
    # dropped
    "p_hi_only": [("          wgmma_rs<HDP>(o, al, dv);\n", "")],
    # a trap after 2^22 polls of an mbarrier
    "trap_in_wait": [(_WAIT, "  uint32_t done, n = 0;\n  do {"),
                     (_WAIT_END,
                      "    if (++n == (1u << 22)) __trap();\n" + _WAIT_END)],
}


BACKWARD = {
    "shipped": [],
    "split_p": [("constexpr bool kSplitP = false;",
                 "constexpr bool kSplitP = true;")],
    "split_ds": [("constexpr bool kSplitDS = false;",
                  "constexpr bool kSplitDS = true;")],
}
def rglru_variant(spec):
    ch, steps, stages = spec.split(",")
    return [("constexpr int kCh = 64;", f"constexpr int kCh = {ch};"),
            ("constexpr int kSteps = 16;", f"constexpr int kSteps = {steps};"),
            ("constexpr int kStages = 3;", f"constexpr int kStages = {stages};")]


# B3' diagnostics (wrong results, timing only): no hand-off waited for
# (a cluster barrier at the end keeps every CTA alive until the last
# arrival on its barriers), or no output stored
_B3P_END = "  }\n}\n\ntemplate <typename T, bool kHasH, bool kVec>\nint launch_bwd_as("
RGLRU_BWD = {
    "no_wait": [("mbar_wait_cluster(smem_u32(&bars[3]), n_bwd++ & 1u);", ""),
                ("mbar_wait_cluster(smem_u32(&bars[2]), n_fwd++ & 1u);", ""),
                (_B3P_END, _B3P_END.replace(
                    "  }\n}", "  }\n  cluster_arrive();\n  cluster_wait();\n}",
                    1))],
    "no_store": [("          store(lam[u], dbb + t * W);\n", ""),
                 ("          store(__fmul_rn(__fmul_rn(lam[u], hprev), "
                  "a[u]), dl + t * W);\n", "")],
}


def rglru_bwd_variant(spec):
    ch, steps, _, *extra = spec.split(",")
    return [("constexpr int kBwdCh = 64;", f"constexpr int kBwdCh = {ch};"),
            ("constexpr int kBwdSteps = 64;",
             f"constexpr int kBwdSteps = {steps};")] + [
                 sub for name in extra for sub in RGLRU_BWD[name]]


def build_variants(source, variants):
    """{name: path of the built library}; prints each ptxas summary."""
    from repro_torch.kernels import build
    text = (CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in {source}.cu")
            src = src.replace(old, new)
        stem = f"{source}_{name.replace(',', '_')}"   # nvcc splits on ','
        cu = OUT / f"{stem}.cu"
        cu.write_text(src)
        lib = OUT / f"lib{stem}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"{source} {name}: {' | '.join(info)}", flush=True)
        libs[name] = lib
    return libs


def use(source, lib):
    """Put a variant's library behind the port's wrapper."""
    from repro_torch.kernels import build
    build._LIBS[source] = ctypes.CDLL(str(lib))


def median_ms(fn, iters=20, warmup=3):
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


def run_rglru(specs, gen):
    from repro_torch.kernels import ops, ref
    libs = build_variants("rglru_scan", {s: rglru_variant(s) for s in specs})

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    log_a = -8.0 * F.softplus(randn(4096) - 6.0) * torch.sigmoid(
        randn(4, 4096, 4096))
    b, h0 = randn(4, 4096, 4096), randn(4, 4096)
    want, want_last = ref.rglru_scan_reference(log_a, b, h0)
    for spec, lib in libs.items():
        use("rglru_scan", lib)
        h, h_last = ops.rglru_scan(log_a, b, h0)
        equal = torch.equal(h, want) and torch.equal(h_last, want_last)
        ms = median_ms(lambda: ops.rglru_scan(log_a, b, h0))
        print(f"rglru_scan (channels, steps, ring) = ({spec}): equal to "
              f"plain {equal}, kernel_ms={ms}", flush=True)


def run_rglru_bwd(specs, gen):
    from kernel_times import device_ms
    from repro_torch.kernels import ops, ref
    libs = build_variants("rglru_scan",
                          {s: rglru_bwd_variant(s) for s in specs})
    evict = torch.zeros(32 << 20, device="cuda")   # 128 MB, above the L2
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        log_a = (-torch.rand(2, 512, 4096, generator=gen, device="cuda")
                 * 0.5).to(dtype)
        b, g = (torch.randn(2, 512, 4096, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        g_last = torch.randn(2, 4096, generator=gen, device="cuda")
        h, _ = ops.rglru_scan(log_a, b)
        want = ref.rglru_scan_backward_reference(log_a, b, None, h, g,
                                                 g_last)
        cases.append((dtype, log_a, b, h, g, g_last, want))
    for spec, lib in libs.items():
        use("rglru_scan", lib)
        ops.B3P_CH, ops.B3P_STEPS, ops.B3P_CLUSTER = map(
            int, spec.split(",")[:3])
        for dtype, log_a, b, h, g, g_last, want in cases:
            def call():
                return ops.rglru_scan_backward(log_a, b, None, h, g, g_last)
            got = call()
            equal = all(torch.equal(x, y) for x, y in zip(got[:2], want))
            ms = median_ms(call)
            dev = device_ms(call, "rglru_scan_bwd", evict=evict)
            print(f"rglru_scan_backward (channels, steps, cluster) = "
                  f"({spec}) {str(dtype).replace('torch.', '')}: equal to "
                  f"plain {equal}, kernel_ms={ms}, device_ms (L2 evicted)="
                  f"{dev}", flush=True)


def run_attention(gen):
    from repro_torch.kernels import ops, ref
    libs = build_variants("flash_attention", ATTENTION)

    def randn(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    kw = dict(causal=True, window=2048, softcap=30.0)
    gates = []
    for qscale in (1.0, 20.0):
        q, k, v = randn(1, 4096, 16, 256), randn(1, 4096, 1, 256), \
            randn(1, 4096, 1, 256)
        q = (q.float() * qscale).to(torch.bfloat16)
        want = ref.attention_reference(q, k, v, **kw).float()
        pv = ref.attention_reference(q.float(), k.float(), v.float().abs(),
                                     **kw)
        gates.append((qscale, q, k, v, want,
                      2.0 ** -7 * want.abs() + 2.0 ** -8 * pv + 1e-5))
        del pv
    q, k, v = randn(4, 4096, 16, 256), randn(4, 4096, 1, 256), \
        randn(4, 4096, 1, 256)
    for name, lib in libs.items():
        use("flash_attention", lib)
        shares = []
        for qscale, q1, k1, v1, want, gate in gates:
            got = ops.flash_attention(q1, k1, v1, **kw).float()
            shares.append(f"q x {qscale}: "
                          f"{float(((got - want).abs() / gate).max()):.4f}")
        ms = median_ms(lambda: ops.flash_attention(q, k, v, **kw))
        ms0 = median_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                    window=2048))
        print(f"flash_attention {name}: gate share {', '.join(shares)}; "
              f"kernel_ms={ms} (softcap 0: {ms0})", flush=True)


def run_backward(gen):
    from kernel_times import BWD_SHAPES
    from repro_torch.kernels import ops, ref
    libs = build_variants("flash_attention_bwd", BACKWARD)
    gate = 2.0 ** -7

    def rel(got, want):
        return max(float((a.float() - b.float()).abs().max())
                   / float(b.float().abs().max())
                   for a, b in zip(got, want))

    for label, ((B, S, H, K, T, hd), kw) in BWD_SHAPES.items():
        for qscale in (1.0, 20.0):
            q, k, v, g = (torch.randn(*s, generator=gen, device="cuda")
                          for s in ((B, S, H, hd), (B, T, K, hd),
                                    (B, T, K, hd), (B, S, H, hd)))
            q = q * qscale
            q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
            want = ref.attention_backward_reference(q, k, v, g, **kw)
            ins = [x.clone().requires_grad_() for x in (q, k, v)]
            route = torch.autograd.grad(ref.attention_reference(*ins, **kw),
                                        ins, g)
            for name, lib in libs.items():
                use("flash_attention_bwd", lib)
                got = ops.flash_attention_backward(q, k, v, g, **kw)
                shares = (rel(got, want) / gate,
                          rel(got, route) / (2 * gate))
                ms = (median_ms(lambda: ops.flash_attention_backward(
                    q, k, v, g, **kw)) if qscale == 1.0 else None)
                print(f"flash_attention_backward {name} {label} q x "
                      f"{qscale}: gate share vs plain {shares[0]:.4f}, vs "
                      f"autograd through plain {shares[1]:.4f}; "
                      f"kernel_ms={ms}", flush=True)
            del q, k, v, g, want, ins, route
            torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    os.chdir(ROOT)
    import repro_torch
    repro_torch.set_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "rglru" and len(sys.argv) > 2:
        run_rglru(sys.argv[2:], gen)
    elif what == "rglru_bwd" and len(sys.argv) > 2:
        run_rglru_bwd(sys.argv[2:], gen)
    elif what == "attention":
        run_attention(gen)
    elif what == "backward":
        run_backward(gen)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
