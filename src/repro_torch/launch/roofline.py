"""The roofline table of a dry run: the port's twin of the JAX package's
``benchmarks/roofline.py``.

Reads the dry-run JSON (``python -m repro_torch.launch.dryrun --all --out
...``) and for each (arch x shape) reports:

* the three roofline terms in seconds on an H100 SXM
  (:data:`repro_torch.core.energy.H100_SXM`: 989.4 TF/s bf16 dense, 3.35
  TB/s HBM3, each mesh axis' collectives at NVLink 450 GB/s inside an HGX
  node or InfiniBand 50 GB/s across nodes),
* the dominant bottleneck,
* MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), with the 2·N·D
  inference factor for prefill and decode, and MODEL_FLOPS / counted
  FLOPs (how much of the counted compute is "useful"),
* a line on what would move the dominant term down.

These are DERIVED from the dispatch records of an eager run on ``meta``
tensors and the data sheet, not measured.

Run: ``PYTHONPATH=src python -m repro_torch.launch.roofline [--report
build/results/dryrun_single_pod.json] [--out build/results/roofline.json]``
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.configs import INPUT_SHAPES, get_arch
from repro_torch.core.energy import H100_SXM, RooflineTerms

MOVE_NOTES = {
    "compute": "increase arithmetic intensity (fuse, larger per-GPU tiles)"
               " or accept: compute-bound is the roofline target",
    "memory": "cut HBM traffic: bf16 caches/params, fuse elementwise chains"
              " (the eager count has no fusion), ZeRO-shard the Adam state",
    "collective": "reshard to cut gather/reduce volume (keep the model axis "
                  "inside an NVLink node), overlap collectives with "
                  "compute, bf16 consensus messages",
}


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # one decoded token


def analyze(report: dict) -> dict:
    link = (report.get("roofline") or {}).get("link_bw", H100_SXM["ib_bw"])
    coll = float(sum(report["collectives"].values()))
    rt = RooflineTerms(flops=report["flops"], hbm_bytes=report["hbm_bytes"],
                       collective_bytes=coll, chips=report["chips"],
                       link_bw=link)
    mf = model_flops(report["arch"], report["shape"])
    return {
        "arch": report["arch"], "shape": report["shape"],
        "mesh": report["mesh"], "chips": report["chips"],
        "t_compute_ms": rt.t_compute * 1e3,
        "t_memory_ms": rt.t_memory * 1e3,
        "t_collective_ms": rt.t_collective * 1e3,
        "bottleneck": rt.bottleneck,
        "step_ms": rt.step_time * 1e3,
        "model_flops": mf,
        "counted_flops": report["flops"],
        "useful_ratio": mf / report["flops"] if report["flops"]
        else float("nan"),
        "peak_gb_per_device": (report.get("bytes_per_device") or 0) / 1e9,
        "fits": report.get("fits"),
        "energy_per_step_J": rt.energy_per_step(),
        "note": MOVE_NOTES[rt.bottleneck],
    }


def _axis_gb(report: dict, axis: str) -> str:
    kinds = report.get("collectives_by_axis", {}).get(axis, {})
    return f"{sum(kinds.values()) / report['chips'] / 1e9:.3g}"


def markdown(single: list, multi: list) -> str:
    """One table of both meshes' reports, a row per (arch, shape): per
    device FLOPs and bytes, collective GB per device by axis, peak GB per
    device and whether it fits in 80 GB on each mesh, the 16 x 16 H100
    roofline terms, its bound, the useful ratio, and the 2 x 16 x 16 step
    time."""
    by = {(r["arch"], r["shape"]): r for r in multi}
    lines = ["| arch × shape | TFLOP/dev | TB/dev | coll GB/dev model · "
             "data (· pod) | peak GB/dev 16×16 · 2×16×16 | fits | compute · "
             "memory · collective ms | bound | useful | 2×16×16 step ms |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for r in single:
        a = analyze(r)
        m = by.get((r["arch"], r["shape"]))
        am = analyze(m) if m else None
        coll = f"{_axis_gb(r, 'model')} · {_axis_gb(r, 'data')}"
        if m:
            coll += (f" ({_axis_gb(m, 'model')} · {_axis_gb(m, 'data')} · "
                     f"{_axis_gb(m, 'pod')})")
        peak = f"{a['peak_gb_per_device']:.2f}"
        peak += f" · {am['peak_gb_per_device']:.2f}" if am else ""
        fits = "yes" if a["fits"] else "no"
        if am:
            fits += " · " + ("yes" if am["fits"] else "no")
        lines.append(
            f"| {r['arch']} × {r['shape']} | {r['flops'] / r['chips'] / 1e12:.4g}"
            f" | {r['hbm_bytes'] / r['chips'] / 1e12:.4g} | {coll} | {peak} "
            f"| {fits} | {a['t_compute_ms']:.4g} · {a['t_memory_ms']:.4g} · "
            f"{a['t_collective_ms']:.4g} | {a['bottleneck']} | "
            f"{a['useful_ratio']:.3f} | "
            f"{am['step_ms']:.4g} |" if am else " — |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default="build/results/dryrun_single_pod.json")
    ap.add_argument("--out", default="build/results/roofline.json")
    ap.add_argument("--markdown", default=None, metavar="MULTI_POD_JSON",
                    help="print one markdown table of --report and this "
                         "multi-pod report instead")
    args = ap.parse_args(argv)
    data = json.loads(Path(args.report).read_text())
    if args.markdown:
        multi = json.loads(Path(args.markdown).read_text())
        print(markdown(data["reports"], multi["reports"]))
        return 1 if data.get("failures") or multi.get("failures") else 0
    rows = [analyze(r) for r in data["reports"]]
    hdr = (f"{'arch':<18}{'shape':<12}{'mesh':<9}{'comp ms':>10}"
           f"{'mem ms':>10}{'coll ms':>10} {'bound':<11}{'useful':>7}"
           f"{'GB/dev':>8} fits")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['arch']:<18}{r['shape']:<12}{r['mesh']:<9}"
              f"{r['t_compute_ms']:>10.2f}{r['t_memory_ms']:>10.2f}"
              f"{r['t_collective_ms']:>10.2f} {r['bottleneck']:<11}"
              f"{r['useful_ratio']:>7.3f}{r['peak_gb_per_device']:>8.2f} "
              f"{r['fits']}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    if data.get("failures"):
        print(f"\nWARNING: {len(data['failures'])} dry-run failures")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
