"""Finding serialization and the baseline diff.

``--format json`` emits the findings as a stable JSON array (the
artifact); ``--format sarif`` emits a minimal SARIF 2.1.0 log (one run,
one rule per rule ID). A committed ``--format json`` artifact is the
BASELINE: the allowlisted findings of the tree at the time, site by
site. With ``--baseline``, strict mode fails on every open finding and
on every allowlisted finding the baseline does not hold, so the baseline
can only tighten the gate: an allowlist entry covers a rule in a whole
file, and the baseline catches a new site under it (a second unpriced
send in an allowlisted module).

A finding's identity is ``(rule, file, scope, message)``, counted: the
enclosing function tells two sites of one message in a file apart, and a
second site in the same function exceeds the baseline's count. Line
numbers drift with unrelated edits, so they are not part of it. A
baseline may hold allowlisted findings only: an open finding is fixed or
allowlisted with a note and ``added_in``, never absorbed by a refresh,
and a baseline that holds one is refused.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Iterable, List, Tuple

from repro_torch.analysis.findings import Finding

#: a finding's identity across runs: all but the line number (drifts) and
#: the allowlist marking (derived, not observed)
Key = Tuple[str, str, str, str]


def finding_key(f: Finding) -> Key:
    return (f.rule, f.file, f.scope, f.message)


def findings_to_json(findings: Iterable[Finding]) -> str:
    """Stable JSON array of finding dicts (the artifact format)."""
    return json.dumps(
        [{"rule": f.rule, "file": f.file, "line": f.line, "scope": f.scope,
          "message": f.message, "allowlisted": f.allowlisted,
          "note": f.note} for f in findings],
        indent=2, sort_keys=True) + "\n"


def findings_to_sarif(findings: Iterable[Finding]) -> str:
    """Minimal SARIF 2.1.0: one run, one driver; allowlisted findings
    carry level "note", open ones "error"."""
    findings = list(findings)
    results = [{
        "ruleId": f.rule,
        "level": "note" if f.allowlisted else "error",
        "message": {"text": f.message + (f" [allowlisted: {f.note}]"
                                         if f.allowlisted else "")},
        "locations": [{"physicalLocation": {
            "artifactLocation": {"uri": f.file},
            "region": {"startLine": max(f.line, 1)},
        }, "logicalLocations": [{"fullyQualifiedName": f.scope}]}],
    } for f in findings]
    log = {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.analysis",
                "rules": [{"id": r} for r in sorted({f.rule
                                                     for f in findings})],
            }},
            "results": results,
        }],
    }
    return json.dumps(log, indent=2, sort_keys=True) + "\n"


def load_baseline(path: str) -> Counter:
    """The counted ``(rule, file, scope, message)`` keys of a ``--format
    json`` artifact. Raises on unreadable or malformed input (a silently
    empty baseline would fail every known finding) and on an open
    finding in it."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise ValueError(
            f"baseline {path!r} holds a {type(data).__name__}, not the "
            "JSON array `--format json` writes — regenerate it with "
            "`python -m repro_torch.analysis --format json`")
    keys: Counter = Counter()
    for i, d in enumerate(data):
        try:
            key = (str(d["rule"]), str(d["file"]), str(d["scope"]),
                   str(d["message"]))
            allowlisted = d["allowlisted"]
        except (TypeError, KeyError) as exc:
            raise ValueError(
                f"baseline {path!r} entry {i} is missing {exc} — every "
                "entry needs rule/file/scope/message/allowlisted; "
                "regenerate the file with `python -m repro_torch.analysis "
                "--format json`")
        if allowlisted is not True:
            raise ValueError(
                f"baseline {path!r} entry {i} ({key[0]} {key[1]}:"
                f"{d.get('line')}) is an open finding — fix it, or "
                "allowlist it with a note and added_in; a baseline holds "
                "allowlisted findings only")
        keys[key] += 1
    return keys


def new_findings(findings: Iterable[Finding],
                 baseline: Counter) -> List[Finding]:
    """The findings a baselined strict run fails on: every open one, and
    every allowlisted one beyond its key's count in the baseline."""
    seen: Counter = Counter()
    out: List[Finding] = []
    for f in findings:
        key = finding_key(f)
        seen[key] += 1
        if not f.allowlisted or seen[key] > baseline[key]:
            out.append(f)
    return out
