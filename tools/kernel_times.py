"""Times of the LM kernels' wrappers of one checkout of this repository,
on one CUDA card, so that two checkouts can be compared inside one call.

  python3 tools/kernel_times.py [--tree DIR] [--out FILE]

imports ``repro_torch`` from ``DIR/src`` (default: this checkout; its
kernels build under ``DIR/build``) and times, each the median of 20
calls by CUDA events on inputs made from one seed:

* B4′ (``ops.flash_attention_backward``), f32 and bf16, at the seven
  training shapes of chip_smoke.py (its ``B4_BWD_SHAPES`` and whisper's
  three), and its device time alone: the sum of its grids' kernels in a
  ``torch.profiler`` trace of 10 calls, over 10 (the events' time also
  holds the wrapper's host work where the card waits for it);
* B4's forward (``ops.flash_attention``), bf16, at the kernel table's
  shape (q (4, 4096, 16, 256), one kv head, window 2048, softcap 30) and
  at granite-8b's training shape;
* B3 (``ops.rglru_scan``) at (4, 4096, 4096) f32 from h0;
* B3′ (``ops.rglru_scan_backward``) at the hybrid's training shape (2,
  512, 4096) from zero with g_last, f32 reading the saved output and
  bf16 (the carry recomputed), and its device time alone, warm (inputs
  left in the 50 MB L2 by the call before) and with the L2 evicted (a
  128 MB buffer read before each call, so that no dirty line is left to
  write back).

It prints the card's name and power limit, one line a kernel and shape,
and one JSON object as its last line (also written to FILE). Run parent,
change, change, parent in one call to compare two versions. It exits
non-zero without a CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: (B, S, H, K, T, hd) and masks: chip_smoke.py's B4′ rows
BWD_SHAPES = {
    "granite-8b": ((4, 512, 32, 8, 512, 128),
                   dict(causal=True, window=0, softcap=0.0)),
    "recurrentgemma-9b local": ((2, 512, 16, 1, 512, 256),
                                dict(causal=True, window=2048,
                                     softcap=30.0)),
    "h2o-danube-3-4b": ((4, 512, 32, 8, 512, 120),
                        dict(causal=True, window=4096, softcap=0.0)),
    "stablelm-3b": ((4, 512, 32, 32, 512, 80),
                    dict(causal=True, window=0, softcap=0.0)),
    "whisper encoder": ((2, 1500, 20, 20, 1500, 64),
                        dict(causal=False, window=0, softcap=0.0)),
    "whisper cross": ((2, 448, 20, 20, 1500, 64),
                      dict(causal=False, window=0, softcap=0.0)),
    "whisper causal self": ((2, 448, 20, 20, 448, 64),
                            dict(causal=True, window=0, softcap=0.0)),
}
FWD_SHAPES = {
    "table (4, 4096, 16, 256) kv 1": ((4, 4096, 16, 1, 4096, 256),
                                      dict(causal=True, window=2048,
                                           softcap=30.0)),
    "granite-8b training": ((4, 512, 32, 8, 512, 128),
                            dict(causal=True, window=0, softcap=0.0)),
}


def median_ms(fn, iters=20, warmup=2):
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


def device_ms(fn, name, n=10, evict=None):
    """Device ms a call of the kernels whose names hold ``name``: their
    sum in a ``torch.profiler`` trace of ``n`` calls (CPU and CUDA
    activities, exported to ``build/profile/kernel_times.json``: the
    trace's kernel events, since ``key_averages()`` of a CUDA-only trace
    was seen to drop some), over ``n``; with ``evict`` (a tensor larger
    than the L2) read before each call. A trace that does not hold a whole
    number of them a call is taken again (the profiler was seen to return
    traces without device events); exits if three in a row do not."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out = ROOT / "build" / "profile" / "kernel_times.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if evict is not None:
                    evict.sum()   # read: the L2 left clean
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(out))
        hits = [e.get("dur", 0)
                for e in json.loads(out.read_text())["traceEvents"]
                if e.get("cat") == "kernel" and name in e.get("name", "")]
        if hits and len(hits) % n == 0:
            return sum(hits) / n / 1e3
        print(f"kernel_times: {name}: the trace of {n} calls holds "
              f"{len(hits)} kernels; tracing again", flush=True)
    raise SystemExit(f"kernel_times: {name}: no whole trace of {n} calls "
                     "in three")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import repro_torch
    from repro_torch.kernels import build, ops
    repro_torch.set_f32_matmul()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{args.tree}: {smi}; built in {build.build():.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    out = {"tree": args.tree, "device": smi, "flash_attention_backward": {},
           "flash_attention_backward_device": {}, "flash_attention": {}}
    for label, ((B, S, H, K, T, hd), kw) in BWD_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, g = randn(B, S, H, hd, dtype=dtype), randn(B, S, H, hd,
                                                          dtype=dtype)
            k, v = randn(B, T, K, hd, dtype=dtype), randn(B, T, K, hd,
                                                          dtype=dtype)

            def call():
                ops.flash_attention_backward(q, k, v, g, **kw)

            ms = median_ms(call)
            dev = device_ms(call, "flash_attention_bwd_")
            name = f"{label} {str(dtype).replace('torch.', '')}"
            out["flash_attention_backward"][name] = ms
            out["flash_attention_backward_device"][name] = dev
            print(f"flash_attention_backward {name}: {ms} ms (device "
                  f"{dev} ms)", flush=True)
            del q, k, v, g
    for label, ((B, S, H, K, T, hd), kw) in FWD_SHAPES.items():
        q = randn(B, S, H, hd, dtype=torch.bfloat16)
        k, v = (randn(B, T, K, hd, dtype=torch.bfloat16) for _ in range(2))
        ms = median_ms(lambda: ops.flash_attention(q, k, v, **kw))
        out["flash_attention"][label] = ms
        print(f"flash_attention {label} bf16: {ms} ms", flush=True)
        del q, k, v
    log_a = -torch.rand(4, 4096, 4096, generator=gen, device="cuda") * 0.5
    b, h0 = randn(4, 4096, 4096), randn(4, 4096)
    out["rglru_scan"] = median_ms(lambda: ops.rglru_scan(log_a, b, h0))
    print(f"rglru_scan (4, 4096, 4096) f32: {out['rglru_scan']} ms",
          flush=True)
    del log_a, b, h0
    evict = torch.zeros(32 << 20, device="cuda")   # 128 MB
    out["rglru_scan_backward"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        log_a = (-torch.rand(2, 512, 4096, generator=gen, device="cuda")
                 * 0.5).to(dtype)
        b, g = randn(2, 512, 4096, dtype=dtype), randn(2, 512, 4096,
                                                        dtype=dtype)
        g_last = randn(2, 4096)
        h, _ = ops.rglru_scan(log_a, b)

        def call():
            ops.rglru_scan_backward(log_a, b, None, h, g, g_last)

        name = f"(2, 512, 4096) {str(dtype).replace('torch.', '')}"
        row = dict(ms=median_ms(call),
                   device_ms=device_ms(call, "rglru_scan_bwd"),
                   device_ms_evicted=device_ms(call, "rglru_scan_bwd",
                                               evict=evict))
        out["rglru_scan_backward"][name] = row
        print(f"rglru_scan_backward {name}: {row['ms']} ms (device "
              f"{row['device_ms']} ms warm, {row['device_ms_evicted']} ms "
              "L2 evicted)", flush=True)
        del log_a, b, g, g_last, h
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
