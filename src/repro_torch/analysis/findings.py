"""Finding records, the allowlist, and report formatting.

The lint layer (:mod:`.lint`) returns a list of :class:`Finding`; the CLI
marks the ones covered by ``analysis/allowlist.toml`` (known debt is
TRACKED with a justification, never silenced), prints the report, and
under ``--strict`` fails on any finding left unallowlisted (with
``--baseline``, also on an allowlisted finding the baseline does not
hold: the baseline only tightens the allowlist).

The allowlist is an array of ``[[allow]]`` tables::

    [[allow]]
    rule     = "R4"                                # the rule ID
    file     = "src/repro_torch/core/consensus.py" # path suffix or glob
    match    = "transmit"                          # optional: message
                                                   # substring
    note     = "why this is intentional"
    added_in = 21                                  # the PR that
                                                   # admitted this debt

Every key but ``match`` is required, each with its type; an unknown key,
a wrong type, or a key given twice in one entry is rejected with its line
number, as is any line the grammar above does not cover. A typo that
parsed to nothing would untrack debt without anyone noticing.

Entries EXPIRE: debt :data:`STALE_AFTER_PRS` or more PRs older than
:data:`CURRENT_PR` is reported as a warning by ``--strict``
(:func:`stale_entries`).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Iterable, List, Tuple

#: the PR this tree is at: bump when a PR lands new allowlist entries
CURRENT_PR = 24

#: an allowlist entry this many PRs old is stale: ``--strict`` warns (the
#: debt stays allowlisted; expiry nags, it does not break)
STALE_AFTER_PRS = 4

#: the keys of an ``[[allow]]`` entry and their types
ALLOW_KEYS = {"rule": str, "file": str, "match": str, "note": str,
              "added_in": int}
REQUIRED_KEYS = ("rule", "file", "note", "added_in")


@dataclasses.dataclass
class Finding:
    """One finding: rule ID, file:line, a message, and the enclosing
    function's qualified name (``scope``; ``<module>`` at top level)."""

    rule: str
    file: str
    line: int
    message: str
    allowlisted: bool = False
    note: str = ""
    scope: str = "<module>"

    def format(self) -> str:
        tail = f"  [allowlisted: {self.note}]" if self.allowlisted else ""
        return f"{self.rule:4s} {self.file}:{self.line}  {self.message}{tail}"


_STRING_RE = re.compile(r'"((?:[^"\\]|\\.)*)"')
_ESCAPES = {"\\\\": "\\", '\\"': '"', "\\n": "\n", "\\t": "\t"}
_HEADER_RE = re.compile(r"^\[\[?[A-Za-z0-9_.\-]+\]\]?$")
#: sentinel: inside a table that is not ours (keys skipped, not errors)
_OTHER_TABLE = object()


def _parse_scalar(v: str, lineno: int):
    m = _STRING_RE.match(v)
    if m:
        trailing = v[m.end():].split("#", 1)[0].strip()
        if trailing:
            raise ValueError(
                f"allowlist line {lineno}: trailing garbage {trailing!r} "
                "after the string value — one scalar per key")
        s = m.group(1)
        for esc, ch in _ESCAPES.items():
            s = s.replace(esc, ch)
        return s
    if v.startswith('"'):
        raise ValueError(f"allowlist line {lineno}: unterminated string "
                         f"{v!r} — close the quote")
    v = v.split("#", 1)[0].strip()
    if v in ("true", "false"):
        return v == "true"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            raise ValueError(
                f"allowlist line {lineno}: {v!r} is not a supported "
                "scalar — quote strings, or use an int/float/bool")


def _check_entry(entry: dict, lineno: int):
    for key in REQUIRED_KEYS:
        if key not in entry:
            raise ValueError(
                f"allowlist line {lineno}: the [[allow]] entry there has "
                f"no {key} — every entry needs "
                f"{', '.join(REQUIRED_KEYS)}")


def parse_allowlist(text: str) -> List[dict]:
    """The ``[[allow]]`` entries of ``text``, strictly (see the module
    docstring); raises ``ValueError`` naming the line of the first fault.
    Tables other than ``[[allow]]`` are skipped whole."""
    entries: List[dict] = []
    cur, start, where = None, 0, {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if isinstance(cur, dict):
                _check_entry(cur, start)
            if line == "[[allow]]":
                cur, start, where = {}, lineno, {}
                entries.append(cur)
                continue
            if not _HEADER_RE.match(line):
                raise ValueError(
                    f"allowlist line {lineno}: malformed table header "
                    f"{line!r} — expected [[allow]] or a [name] table")
            cur = _OTHER_TABLE
            continue
        if cur is _OTHER_TABLE:
            continue
        if cur is None:
            raise ValueError(
                f"allowlist line {lineno}: {line!r} outside any table — "
                "every key belongs under an [[allow]] header")
        k, eq, v = line.partition("=")
        k = k.strip()
        if not eq or not k:
            raise ValueError(
                f"allowlist line {lineno}: {line!r} is not a `key = "
                "value` pair inside [[allow]]")
        if k not in ALLOW_KEYS:
            raise ValueError(
                f"allowlist line {lineno}: unknown key {k!r} — an "
                f"[[allow]] entry takes {', '.join(ALLOW_KEYS)}")
        if k in cur:
            raise ValueError(
                f"allowlist line {lineno}: duplicate key {k!r} in one "
                f"[[allow]] entry (first given at line {where[k]}) — "
                "keep one")
        value = _parse_scalar(v.strip(), lineno)
        want = ALLOW_KEYS[k]
        if type(value) is not want:
            raise ValueError(
                f"allowlist line {lineno}: {k} = {value!r} is a "
                f"{type(value).__name__}; {k} takes a {want.__name__}")
        cur[k], where[k] = value, lineno
    if isinstance(cur, dict):
        _check_entry(cur, start)
    return entries


def load_allowlist(path: str) -> List[dict]:
    """The ``[[allow]]`` entries of ``path`` ([] when the file is
    absent); a malformed file raises ``ValueError``."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return []
    return parse_allowlist(text)


def stale_entries(entries: Iterable[dict], current_pr: int = CURRENT_PR,
                  stale_after: int = STALE_AFTER_PRS
                  ) -> List[Tuple[dict, str]]:
    """(entry, warning) pairs for allowlist debt due a revisit: entries
    ``stale_after`` or more PRs old, or undated."""
    out: List[Tuple[dict, str]] = []
    for e in entries:
        added = e.get("added_in")
        label = f"{e.get('rule', '?')} @ {e.get('file', '*')}"
        if added is None:
            out.append((e, f"allowlist entry {label} has no added_in= "
                           "PR — undated debt never expires; date it"))
        elif current_pr - int(added) >= stale_after:
            out.append((e, f"allowlist entry {label} is "
                           f"{current_pr - int(added)} PRs old "
                           f"(added_in={added}, now PR {current_pr}) — "
                           "revisit: fix the finding or re-justify the "
                           "debt"))
    return out


def dedup_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Drop exact duplicates (same rule, file, line and message), keeping
    the first occurrence's order."""
    seen = set()
    out: List[Finding] = []
    for f in findings:
        key = (f.rule, f.file, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _file_matches(finding_file: str, pattern: str) -> bool:
    f = finding_file.replace("\\", "/")
    return (f == pattern or f.endswith("/" + pattern) or f.endswith(pattern)
            or fnmatch.fnmatch(f, pattern))


def apply_allowlist(findings: Iterable[Finding],
                    entries: Iterable[dict]) -> List[Finding]:
    """Mark the findings an allowlist entry covers (first match wins)."""
    findings = list(findings)
    for f in findings:
        for e in entries:
            if e.get("rule") != f.rule:
                continue
            if not _file_matches(f.file, str(e.get("file", "*"))):
                continue
            needle = e.get("match")
            if needle and str(needle) not in f.message:
                continue
            f.allowlisted = True
            f.note = str(e.get("note", ""))
            break
    return findings


def render_report(findings: List[Finding]) -> str:
    """Human report: open findings first, allowlisted debt after."""
    open_f = [f for f in findings if not f.allowlisted]
    known = [f for f in findings if f.allowlisted]
    lines = []
    if open_f:
        lines.append(f"== {len(open_f)} finding(s) ==")
        lines += [f.format() for f in open_f]
    if known:
        lines.append(f"== {len(known)} allowlisted (tracked debt) ==")
        lines += [f.format() for f in known]
    if not findings:
        lines.append("no findings")
    return "\n".join(lines)
