"""The production-mesh dry run: every (architecture x input shape) step on
the JAX package's 16 x 16 (or 2 x 16 x 16) mesh, priced on an H100 SXM.
The port's counterpart of the JAX package's ``launch/dryrun.py``.

The JAX package lowers and compiles each step for 256 (512) placeholder
host devices and reads the compiled program. Here this process is rank 0
of a ``FakeStore`` process group of 256 (512) ranks (``backend="fake"``:
collectives move nothing) that holds :func:`repro_torch.launch.mesh.
make_production_mesh`; the step (:func:`repro_torch.launch.steps.
lower_step`: train with Adam, prefill, or one decode token) runs EAGERLY
on ``meta`` tensors at this rank's shapes (params, Adam state and caches
by the placement table, the batch over the data axes), and its dispatch
records give FLOPs, bytes, collective bytes by mesh axis and the peak
bytes per device (:mod:`repro_torch.launch.hlo_analysis`, which states
the conventions). Nothing is computed and no card is needed.

Each report is priced by :class:`repro_torch.core.energy.RooflineTerms`
on :data:`~repro_torch.core.energy.H100_SXM`, each axis' collectives at
NVLink when its group fits in one 8-GPU HGX node and at InfiniBand when it
spans nodes: on the 16 x 16 mesh both axes span nodes (a model group is 16
consecutive ranks, two nodes; a data group strides 16 ranks), so every
collective is priced at InfiniBand. The figures are derived from the data
sheet, not measured.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod] [--out build/results/dryrun_single_pod.json]

``--out`` resumes: pairs already in the file are skipped. Every failure is
listed and makes the exit code 1. The JAX CLI's ``--probe`` (its
scan-corrected probes, :mod:`repro_torch.launch.probes`) has no
counterpart: the eager run counts every layer and time step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import INPUT_SHAPES, get_arch, list_archs
from repro_torch.core.energy import H100_SXM, link_bw
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.hlo_analysis import StepRecorder, analyze_compiled

# (arch, shape) pairs excluded from long_500k with the reason recorded:
# full-attention archs cannot serve 512k contexts (the JAX package's list)
LONG_CONTEXT_SKIPS = {
    "granite-8b": "full attention (llama arch); no SWA variant claimed",
    "chameleon-34b": "full attention early-fusion VLM",
    "stablelm-3b": "full attention (MHA)",
    "deepseek-7b": "full attention (MHA)",
    "whisper-large-v3": "decoder ctx 448; full attention enc-dec",
    "paper-dqn": "not a sequence model",
}


def runnable(arch: str, shape_name: str) -> bool:
    if arch == "paper-dqn":
        return False
    if shape_name == "long_500k" and arch in LONG_CONTEXT_SKIPS:
        return False
    return True


def fake_group(world: int):
    """Start a ``FakeStore`` group of ``world`` ranks in this process (rank
    0): placements, shapes and dispatches, no data moved."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    # the fake backend for CPU and for meta tensors (p2p ops look up a
    # backend by the tensors' device)
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=0,
                            world_size=world)


def axis_links(mesh) -> dict:
    """{axis: (group name, link bytes/s)}: each axis' group (rank 0's,
    ranks laid out row-major) priced at NVLink when it fits in one HGX
    node, else at InfiniBand."""
    shape = tuple(mesh.mesh.shape)
    out = {}
    for i, a in enumerate(mesh.mesh_dim_names):
        stride = int(np.prod(shape[i + 1:])) if i + 1 < len(shape) else 1
        span = stride * (shape[i] - 1) + 1      # ranks the group covers
        out[a] = (mesh.get_group(a).group_name, link_bw(span))
    return out


def measure(step, inputs, mesh, *, arch, shape_name, mesh_name, chips):
    """Run ``step(*inputs)`` once under the recorders; its report."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    links = axis_links(mesh)
    rec = StepRecorder({g: a for a, (g, _) in links.items()})
    mt = MemTracker()
    mt.track_external(*[t for t in _leaves(inputs)
                        if isinstance(t, torch.Tensor)])
    t0 = time.perf_counter()
    with mt, FlopCounterMode(display=False) as fc, rec.recording():
        step(*inputs)
    secs = time.perf_counter() - t0
    peak = mt.get_tracker_snapshot("peak")[torch.device("meta")]["Total"]
    return analyze_compiled(
        rec, fc, peak, arch=arch, shape=shape_name, mesh_name=mesh_name,
        chips=chips, axis_link_bw={a: bw for a, (_, bw) in links.items()},
        compile_seconds=secs), rec


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def dry_run_one(arch: str, shape_name: str, *, mesh=None,
                multi_pod: bool = False, cfg=None, verbose: bool = True):
    """One (arch, shape) on ``mesh`` (default: the production mesh on the
    running fake group): its :class:`~repro_torch.launch.hlo_analysis.
    DryRunReport`. ``cfg`` replaces the registered config (a cut one)."""
    cfg = cfg or get_arch(arch)
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
    dims = tuple(mesh.mesh.shape)
    mesh_name = "x".join(str(d) for d in dims)
    chips = int(np.prod(dims))
    step, inputs = steps.lower_step(cfg, mesh, shape)
    report, _ = measure(step, inputs, mesh, arch=arch,
                        shape_name=shape.name, mesh_name=mesh_name,
                        chips=chips)
    if verbose:
        print_report(report)
    return report


def fits(report) -> bool:
    return report.bytes_per_device is not None and \
        report.bytes_per_device <= H100_SXM["hbm_bytes"]


def print_report(r):
    rt = r.roofline()
    colls = {a: {k: f"{v:.3e}" for k, v in kinds.items()}
             for a, kinds in r.collectives_by_axis.items()}
    print(f"== {r.arch} x {r.shape} x {r.mesh} (eager meta run "
          f"{r.compile_seconds:.1f} s)")
    print(f"   flops={r.flops:.4e} bytes={r.hbm_bytes:.4e} "
          f"peak/device={r.bytes_per_device / 1e9:.2f} GB "
          f"fits 80 GB: {fits(r)}")
    print(f"   collectives by axis: {colls}")
    print(f"   H100 roofline: compute {rt.t_compute * 1e3:.3f} ms | memory "
          f"{rt.t_memory * 1e3:.3f} ms | collective "
          f"{rt.t_collective * 1e3:.3f} ms -> {rt.bottleneck}-bound, "
          f"{rt.energy_per_step():.1f} J a step (derived from the data "
          "sheet, not measured)", flush=True)


def report_dict(r) -> dict:
    """A report as the ``--out`` JSON holds it: its fields, ``fits`` and
    the H100 roofline terms."""
    d = dataclasses.asdict(r)
    rt = r.roofline()
    d.update(fits=fits(r), roofline={
        "t_compute": rt.t_compute, "t_memory": rt.t_memory,
        "t_collective": rt.t_collective, "bottleneck": rt.bottleneck,
        "step_time": rt.step_time, "link_bw": rt.link_bw,
        "energy_per_step_J": rt.energy_per_step()})
    return d


def reduced_reports(cases, *, data: int = 2, model: int = 2) -> list:
    """Each case (arch, :class:`~repro_torch.configs.InputShape`, config
    overrides) dry-run at its reduced size (``repro_torch.configs.
    reduced``) on a fake data x model group started and torn down here:
    the report dicts."""
    from repro_torch.configs import reduced

    fake_group(data * model)
    try:
        mesh = mesh_lib.make_host_mesh(data, model, device_type="cpu")
        return [report_dict(dry_run_one(
            arch, shape, mesh=mesh, verbose=False,
            cfg=dataclasses.replace(reduced(get_arch(arch)), **over)))
            for arch, shape, over in cases]
    finally:
        mesh_lib.destroy_local_group()


def production_report(arch: str, shape_name: str, *,
                      multi_pod: bool = False) -> dict:
    """One pair on the production mesh of a fake group started and torn
    down here: the report dict."""
    fake_group(512 if multi_pod else 256)
    try:
        return report_dict(dry_run_one(arch, shape_name,
                                       multi_pod=multi_pod, verbose=False))
    finally:
        mesh_lib.destroy_local_group()


def _custom(args) -> int:
    """One (arch, shape) cut to ``--layers`` / ``--batch`` /
    ``--seq-len``, on ``--mesh`` (e.g. the card's 1 x 1) or the production
    mesh: how the smoke predicts a step it then measures on the card."""
    if not (args.arch and args.shape) or args.all:
        raise SystemExit(
            f"--layers/--batch/--seq-len/--mesh take one --arch and one "
            f"--shape (got --arch {args.arch!r}, --shape {args.shape!r}, "
            f"--all {args.all}); e.g. --arch granite-8b --shape train_4k")
    cfg = get_arch(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    base = INPUT_SHAPES[args.shape]
    shape = dataclasses.replace(
        base, seq_len=args.seq_len or base.seq_len,
        global_batch=args.batch or base.global_batch)
    dims = ((512 if args.multi_pod else 256,) if args.mesh is None else
            tuple(int(x) for x in args.mesh.lower().split("x")))
    fake_group(int(np.prod(dims)))
    try:
        mesh = (mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                              device_type="cpu")
                if args.mesh is None else
                mesh_lib.make_host_mesh(*dims, device_type="cpu"))
        d = report_dict(dry_run_one(args.arch, shape, mesh=mesh, cfg=cfg))
    finally:
        mesh_lib.destroy_local_group()
    if args.json:
        print(json.dumps(d))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every runnable (arch x shape) on this mesh")
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to this many layers (one pair)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's (one pair)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="a host mesh on a fake group of DATA x MODEL "
                         "ranks in place of the production mesh (one pair)")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON on the last line")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --arch and/or --shape, or --all")
    if any(x is not None for x in (args.layers, args.batch, args.seq_len,
                                   args.mesh)):
        return _custom(args)

    archs = [args.arch] if args.arch else [a for a in list_archs()
                                           if a != "paper-dqn"]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    pairs = []
    for a in archs:
        for s in shapes:
            if runnable(a, s):
                pairs.append((a, s))
            elif args.arch or args.shape:
                print(f"SKIP {a} x {s}: "
                      f"{LONG_CONTEXT_SKIPS.get(a, 'excluded')}")

    reports, failures, done = [], [], set()
    if args.out:
        try:
            prev = json.loads(Path(args.out).read_text())
            reports = prev.get("reports", [])
            done = {(r["arch"], r["shape"]) for r in reports}
        except (OSError, json.JSONDecodeError):
            pass

    def save():
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(
                {"reports": reports, "failures": failures}, indent=1))

    fake_group(512 if args.multi_pod else 256)
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=args.multi_pod,
                                             device_type="cpu")
        for a, s in pairs:
            if (a, s) in done:
                print(f"skip {a} x {s}: already in {args.out}")
                continue
            try:
                reports.append(report_dict(dry_run_one(a, s, mesh=mesh)))
            except Exception as e:   # a failure here is a bug in the port
                failures.append((a, s, repr(e)))
                print(f"FAIL {a} x {s}: {e!r}", flush=True)
            save()
    finally:
        mesh_lib.destroy_local_group()
    save()
    for a, s, e in failures:
        print(f"FAILED {a} x {s}: {e}")
    print(f"\n{len(reports)} ok, {len(failures)} failed "
          f"({'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
