"""``repro_torch.analysis`` — the port's source rules.

The port's copy of the source layer of the JAX package's
``repro.analysis``: an AST lint (:mod:`.lint`, rules R1, R2', R3, R4 and
R6) over ``src/repro_torch/``, ``chip_smoke.py`` and ``tools/``, the
findings, the allowlist (``allowlist.toml``: known debt, each entry with
a note and the PR that admitted it) and the baseline diff. Those rules
guard invariants the port claims: one draw site, truthful Eq. (11),
median-of-N timing, no compiled code in place of a kernel, named
errors.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis            # report
    PYTHONPATH=src python -m repro_torch.analysis --strict \\
        --baseline src/repro_torch/analysis/baseline.json   # open findings
                                                            # and new sites
    PYTHONPATH=src python -m repro_torch.analysis --format json   # artifact

It imports nothing of the code it reads.
"""
from repro_torch.analysis.findings import (Finding, apply_allowlist,
                                           dedup_findings, load_allowlist,
                                           render_report, stale_entries)

__all__ = ["Finding", "apply_allowlist", "dedup_findings",
           "load_allowlist", "render_report", "stale_entries"]
