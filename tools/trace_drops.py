"""How a ``torch.profiler`` trace on a CUDA card keeps a kernel's events
over a process's life, and the device time that
``repro_torch.kernels.timing.device_ms`` reads by CUDA events instead.

  PYTHONPATH=src python3 tools/trace_drops.py [--seconds 240] [--every 5]
      [--out FILE]

Traces B3′ (``ops.rglru_scan_backward``) at (2, 256, 512) f32 with h0
and g_last, ten calls a trace (the chip smoke's ``train_lm`` read; CPU
and CUDA activities, the exported trace's events), bare and with the
card idle for ``PAD_S`` at each end of the window, in turn, then reads
``device_ms`` of the same call; every ``--every`` seconds for
``--seconds``, the card kept busy in between with a captured matmul
replayed. Prints the card's name and power limit and one JSON object a
trace: seconds since the start, the pad, the B3′ kernels found of the
ten launched, every kernel event and kernel launch in the trace, the
median lag from a launch to its kernel's start, the room from the
window's start to the first kernel and from the last kernel's end to the
window's end (µs), the profiler's device ms a call where the trace holds
all ten and ``device_ms``'s. The last line (also written to FILE) gives,
for each pad, the traces short of ten, and the median of each device
time. Exits non-zero without a CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
#: seconds of idle card at each end of a padded trace's window
PAD_S = 0.1
NAME = "rglru_scan_bwd_kernel"


def trace(fn, path, n, pad):
    """The parsed chrome trace of ``n`` calls of ``fn``, ``pad`` seconds of
    idle card before the first and after the last (kept at ``path``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(pad)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def facts(ev):
    """What the trace ``ev`` holds (see the module docstring)."""
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and e.get("name", "").startswith(("cudaLaunchKernel",
                                                "cuLaunchKernel"))
              and "correlation" in e.get("args", {})}
    window = next((e for e in ev if e.get("cat") == "Trace"), None)
    lags = [k["ts"] - launch[c]["ts"] for k in kernels
            if (c := k.get("args", {}).get("correlation")) in launch]
    head = tail = None
    if kernels and window is not None:
        head = min(k["ts"] for k in kernels) - window["ts"]
        tail = (window["ts"] + window["dur"]
                - max(k["ts"] + k.get("dur", 0) for k in kernels))
    durs = [k.get("dur", 0) for k in kernels if NAME in k.get("name", "")]
    return dict(found=len(durs), kernels=len(kernels), launches=len(launch),
                lag_us=statistics.median(lags) if lags else None,
                head_us=head, tail_us=tail,
                profiler_ms=sum(durs) / 10 / 1e3 if len(durs) == 10
                else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--every", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_drops: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops, timing
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; built in {build.build(['rglru_scan']):.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    log_a = -torch.rand(2, 256, 512, generator=gen, device="cuda") * 0.5
    b, g, h0, g_last = randn(2, 256, 512), randn(2, 256, 512), \
        randn(2, 512), randn(2, 512)
    h, _ = ops.rglru_scan(log_a, b, h0)

    def call():
        ops.rglru_scan_backward(log_a, b, h0, h, g, g_last)

    call()
    busy = randn(4096, 4096)
    busy @ busy
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):     # the smoke replays captured programs
        busy @ busy
    path = ROOT / "build" / "profile" / "trace_drops.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    rows, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for pad in (0.0, PAD_S):
            now = time.perf_counter() - t0
            row = dict(t_s=now, pad_s=pad, **facts(trace(call, path, 10, pad)))
            row["device_ms"] = timing.device_ms(call)
            rows.append(row)
            print(json.dumps(row), flush=True)
        until = time.perf_counter() + args.every
        while time.perf_counter() < until:
            graph.replay()
            torch.cuda.synchronize()
    summary = {"device": smi, "device_ms_median": statistics.median(
        r["device_ms"] for r in rows)}
    for pad in (0.0, PAD_S):
        mine = [r for r in rows if r["pad_s"] == pad]
        whole = [r["profiler_ms"] for r in mine if r["found"] == 10]
        summary[f"pad {pad}"] = dict(
            traces=len(mine), short=len(mine) - len(whole),
            profiler_ms_median=statistics.median(whole) if whole else None)
    line = json.dumps(summary)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
