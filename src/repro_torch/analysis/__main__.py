"""CLI: ``python -m repro_torch.analysis [--strict] [--layer
all|lint|cost|programs] [--device cpu|cuda] [--baseline FILE] [--json-out
FILE] [--format text|json|sarif]``.

``--layer lint`` runs the source rules (:mod:`.lint`), ``--layer cost``
the cost model (:mod:`.costmodel`: C2, C1a and C3 on a gloo group of 8
processes spawned on this host, C3 over the chunked drivers, the C1b
matrix), ``--layer programs`` the program rules (:mod:`.programs`: JX1,
JX4 and JX5 over the cached round programs, JX3 over the captured ones),
``--layer all`` (default) all three. ``--device`` is where the cost and
programs layers' rounds run: ``cuda`` (default; there also C2 and C1b at
the paper-DQN width of K = 256 with B1/B2 launching, and the round
programs captured as CUDA graphs) or ``cpu`` (the gloo group is on the
CPU whatever it says).

``--format text`` (default) prints the human report, ``--format json``
the findings as a stable JSON array (the artifact), ``--format sarif`` a
SARIF 2.1.0 log. ``--json-out PATH`` also writes the JSON artifact to
``PATH`` whatever stdout shows.

The committed JSON artifact is the BASELINE::

    python -m repro_torch.analysis --strict \\
        --baseline src/repro_torch/analysis/baseline.json [--device cpu]

With ``--baseline``, strict mode fails on every open finding and on
every allowlisted finding whose ``(rule, file, scope, message)`` site the
baseline does not hold (:mod:`.baseline`): a new site under a file-wide
allowlist entry is gated too. Refreshing the baseline is a deliberate
commit of a ``--format json`` run of a tree with no open finding; a
baseline that holds an open finding is refused. An unreadable or
malformed baseline or allowlist is an error, never an empty set. Under
``--strict`` the CLI also warns on stale allowlist entries.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch.analysis.baseline import (findings_to_json,
                                           findings_to_sarif, load_baseline,
                                           new_findings)
from repro_torch.analysis.findings import (apply_allowlist, dedup_findings,
                                           load_allowlist, render_report,
                                           stale_entries)
from repro_torch.analysis.lint import run_lint

LAYERS = ("all", "lint", "cost", "programs")

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
#: the repository root: two levels above the ``src/`` package
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(PKG_DIR)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="audit the port's invariants: source rules "
                    "(repro_torch.analysis.lint) and the Eq.-(11) cost "
                    "model (repro_torch.analysis.costmodel)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any finding not allowlisted; with "
                         "--baseline, also on an allowlisted site not in "
                         "it")
    ap.add_argument("--layer", choices=LAYERS, default="all")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the cost and programs layers' rounds run "
                         "(the gloo group runs on the CPU either way)")
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repository root to lint (default: this "
                         "checkout)")
    ap.add_argument("--allowlist", default=os.path.join(PKG_DIR,
                                                        "allowlist.toml"))
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default="text", dest="fmt")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="a committed --format json artifact")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="also write the JSON artifact here")
    args = ap.parse_args(argv)

    # fail fast on a malformed baseline or allowlist
    baseline = (load_baseline(args.baseline)
                if args.baseline is not None else None)
    entries = load_allowlist(args.allowlist)
    findings, timings = [], []
    if args.layer in ("all", "lint"):
        t0 = time.monotonic()
        findings += run_lint(args.root)
        timings.append(("lint", time.monotonic() - t0))
    if args.layer in ("all", "cost"):
        from repro_torch.analysis.costmodel import run_cost_audit
        t0 = time.monotonic()
        findings += run_cost_audit(args.device)
        timings.append(("cost", time.monotonic() - t0))
    if args.layer in ("all", "programs"):
        from repro_torch.analysis.programs import run_program_audit
        t0 = time.monotonic()
        findings += run_program_audit(args.device)
        timings.append(("programs", time.monotonic() - t0))
    findings = apply_allowlist(dedup_findings(findings), entries)

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            fh.write(findings_to_json(findings))
    if args.fmt == "json":
        sys.stdout.write(findings_to_json(findings))
    elif args.fmt == "sarif":
        sys.stdout.write(findings_to_sarif(findings))
    else:
        print(render_report(findings))
        n_open = sum(1 for f in findings if not f.allowlisted)
        print(f"\n{n_open} open finding(s), {len(findings) - n_open} "
              "allowlisted")
    if args.strict:
        for name, dt in timings:
            print(f"[timing] {name:5s} {dt:7.2f}s", file=sys.stderr)
        for _e, warning in stale_entries(entries):
            print(f"[stale] {warning}", file=sys.stderr)

    if not args.strict:
        return 0
    if baseline is None:
        return int(any(not f.allowlisted for f in findings))
    fresh = new_findings(findings, baseline)
    if fresh:
        print(f"[baseline] {len(fresh)} NEW finding(s) not in "
              f"{args.baseline}:", file=sys.stderr)
        for f in fresh:
            print("  " + f.format(), file=sys.stderr)
    return int(bool(fresh))


if __name__ == "__main__":
    sys.exit(main())
