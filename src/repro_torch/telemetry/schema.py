"""Event schema + JSONL validation for the telemetry stream.

``python -m repro_torch.telemetry.schema out.jsonl`` exits 0 iff every
line parses as strict JSON and every event carries the fields its driver
promises, correctly typed. No external schema library: the checks are a
plain field table, which is also the authoritative documentation of the
event format.
"""
from __future__ import annotations

import json
import sys

#: fields every event carries.
COMMON_FIELDS = {
    "type": str,           # "round"
    "driver": str,         # "fl" | "maml" | "consensus"
    "round": int,
    "live": bool,
}

#: link-billed drivers (fl / consensus) add the Eq.-(11) ledger fields.
LEDGER_FIELDS = {
    "reached": bool,
    "metric": float,
    "disagreement": float,
    "n_sl": int, "n_ul": int, "n_dl": int, "edges": int,
    "wire_bits": float,
    "joules_sl": float, "joules_ul": float, "joules_dl": float,
    "joules": float,
    "plan": str, "topology": str, "K": int,
    # async availability observables (K and 0 on lockstep rounds)
    "n_active": int, "max_age": int,
    # per-SENDER attribution: length-K lists summing to n_sl/n_ul/n_dl
    # and the per-agent Eq.-(11) joules (0.0 for a sleeping agent)
    "agent_sl": list, "agent_ul": list, "agent_dl": list,
    "agent_joules": list,
}

#: meta-training events carry losses instead of a link ledger.
MAML_FIELDS = {
    "meta_loss": float,
}


def _check(event: dict, fields: dict, errors: list, where: str):
    for name, typ in fields.items():
        if name not in event:
            errors.append(f"{where}: missing field {name!r}")
        elif typ is float:
            if not isinstance(event[name], (int, float)) \
                    or isinstance(event[name], bool):
                errors.append(f"{where}: field {name!r} is "
                              f"{type(event[name]).__name__}, not number")
        elif not isinstance(event[name], typ):
            errors.append(f"{where}: field {name!r} is "
                          f"{type(event[name]).__name__}, "
                          f"not {typ.__name__}")


def validate_event(event: dict, where: str = "event") -> list:
    """List of problems with one event dict (empty = valid)."""
    errors: list = []
    if not isinstance(event, dict):
        return [f"{where}: not a JSON object"]
    _check(event, COMMON_FIELDS, errors, where)
    driver = event.get("driver")
    if driver in ("fl", "consensus"):
        _check(event, LEDGER_FIELDS, errors, where)
    elif driver == "maml":
        _check(event, MAML_FIELDS, errors, where)
    elif isinstance(driver, str):
        errors.append(f"{where}: unknown driver {driver!r}")
    return errors


def validate_jsonl(path) -> tuple:
    """(#valid events, list of problems) for a JSONL file."""
    errors: list = []
    count = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            where = f"{path}:{lineno}"
            try:
                # parse_constant: reject NaN/Infinity — strict JSON only
                event = json.loads(line, parse_constant=lambda s: (
                    (_ for _ in ()).throw(ValueError(s))))
            except ValueError as exc:
                errors.append(f"{where}: invalid JSON ({exc})")
                continue
            errs = validate_event(event, where)
            errors.extend(errs)
            if not errs:
                count += 1
    return count, errors


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: python -m repro_torch.telemetry.schema <events.jsonl>",
              file=sys.stderr)
        return 2
    count, errors = validate_jsonl(argv[0])
    for e in errors:
        print(e, file=sys.stderr)
    if errors:
        print(f"{argv[0]}: {len(errors)} schema problem(s)",
              file=sys.stderr)
        return 1
    if count == 0:
        print(f"{argv[0]}: no events", file=sys.stderr)
        return 1
    print(f"{argv[0]}: {count} events OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
