"""The port's source rules (``repro_torch.analysis``): every rule fires on
a seeded violation with its rule ID and file:line and stays silent on
its clean counterpart; the strict allowlist parser rejects what it
should, with the line; the baseline round-trips through JSON and SARIF;
the CLI gates on new findings only; and the live tree is clean under the
committed allowlist and baseline. Seeded violations are written under
``tmp_path`` only, never under ``src/`` (the JAX package's own lint walks
``src/``)."""
import dataclasses
import json
import os
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.analysis.baseline import (finding_key,  # noqa: E402
                                           findings_to_json,
                                           findings_to_sarif,
                                           load_baseline, new_findings)
from repro_torch.analysis.findings import (Finding,  # noqa: E402
                                           _file_matches, apply_allowlist,
                                           dedup_findings, load_allowlist,
                                           parse_allowlist, stale_entries)
from repro_torch.analysis.lint import lint_file, run_lint  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch" / "analysis"


def _lint_src(tmp_path, src: str, rel: str):
    p = tmp_path / os.path.basename(rel)
    p.write_text(src, encoding="utf-8")
    return lint_file(str(p), rel)


def _hits(findings, rule):
    return [f for f in findings if f.rule == rule]


# -- R1: one home for threefry draws -------------------------------------------

R1_SRC = (
    "from repro_torch.core import prng\n"
    "def edge_mask(key, t):\n"
    "    k = key\n"
    "    return prng.uniform(prng.fold_in(k, t)) >= 0.5\n")


def test_r1_fires_with_line(tmp_path):
    rel = "src/repro_torch/core/fake_edges.py"
    hits = _hits(_lint_src(tmp_path, R1_SRC, rel), "R1")
    assert [(h.file, h.line) for h in hits] == [(rel, 4), (rel, 4)]
    assert {h.message.split("()")[0] for h in hits} == {
        "threefry draw prng.uniform", "threefry draw prng.fold_in"}
    assert all("edge_mask()" in h.message and "survival_mask" in h.message
               for h in hits)


@pytest.mark.parametrize("src", [
    "from repro_torch.core.prng import fold_in as fi\n"
    "def f(k):\n    return fi(k, 3)\n",
    "import repro_torch.core.prng as P\n"
    "def f(k):\n    return P.bits(k)\n",
    "import repro_torch.core.prng\n"
    "def f(k):\n    return repro_torch.core.prng.threefry2x32(k, k, k, k)\n",
])
def test_r1_follows_import_aliases(tmp_path, src):
    hits = _hits(_lint_src(tmp_path, src, "chip_smoke.py"), "R1")
    assert [h.line for h in hits] == [3]


def test_r1_homes_and_definitions_are_silent(tmp_path):
    home = R1_SRC.replace("def edge_mask", "def survival_mask")
    assert not _hits(_lint_src(tmp_path, home,
                               "src/repro_torch/core/topology.py"), "R1")
    agents = R1_SRC.replace("def edge_mask", "def availability_mask")
    assert not _hits(_lint_src(tmp_path, agents,
                               "src/repro_torch/core/topology.py"), "R1")
    assert not _hits(_lint_src(tmp_path, R1_SRC,
                               "src/repro_torch/core/prng.py"), "R1")
    # a home's name elsewhere is no home; other modules' uniform is no draw
    assert _hits(_lint_src(tmp_path, home, "src/repro_torch/rl/x.py"), "R1")
    other = "import numpy as np\ndef f(r):\n    return np.random.uniform(r)\n"
    assert not _hits(_lint_src(tmp_path, other, "tools/x.py"), "R1")


# -- R2': no torch.compile -----------------------------------------------------

R2_SRC = (
    "import torch\n"
    "@torch.compile\n"
    "def step(p):\n"
    "    return p\n"
    "fast = torch.compile(lambda x: x)\n")


@pytest.mark.parametrize("rel", ["src/repro_torch/kernels/fake_ops.py",
                                 "src/repro_torch/models/fake.py",
                                 "chip_smoke.py"])
def test_r2_torch_compile_fires(tmp_path, rel):
    hits = _hits(_lint_src(tmp_path, R2_SRC, rel), "R2'")
    assert [(h.file, h.line) for h in hits] == [(rel, 2), (rel, 5)]
    src = "from torch import compile as c\nf = c(g)\n"
    assert [h.line for h in _hits(_lint_src(tmp_path, src, rel),
                                  "R2'")] == [1]


def test_r2_clean_and_out_of_scope(tmp_path):
    clean = "import torch\ndef step(p):\n    return torch.relu(p)\n"
    assert not _hits(_lint_src(tmp_path, clean,
                               "src/repro_torch/kernels/fake_ops.py"), "R2'")
    assert not _hits(_lint_src(tmp_path, R2_SRC, "tools/variant.py"), "R2'")
    re_compile = "import re\nP = re.compile('x')\n"
    assert not _hits(_lint_src(tmp_path, re_compile,
                               "src/repro_torch/core/x.py"), "R2'")


# -- R3: median-of-N timing ----------------------------------------------------

R3_BAD = "rows = run()\nassert rows[-1]['ms_per_round'] < 2.0\n"
R3_OK = ("import statistics\n"
         "rows = run()\n"
         "med = statistics.median(r['ms_per_round'] for r in rows)\n"
         "assert med < 2.0 * 1.15\n")


@pytest.mark.parametrize("rel", ["chip_smoke.py", "tools/fake_bench.py",
                                 "src/repro_torch/launch/consensus_scale.py",
                                 "src/repro_torch/rl/fig4_tradeoff.py"])
def test_r3_single_shot_fires_and_median_is_clean(tmp_path, rel):
    hits = _hits(_lint_src(tmp_path, R3_BAD, rel), "R3")
    assert [(h.file, h.line) for h in hits] == [(rel, 2)]
    assert not _hits(_lint_src(tmp_path, R3_OK, rel), "R3")


def test_r3_scope(tmp_path):
    for rel in ("src/repro_torch/core/fake.py", "tests/test_x.py",
                "src/repro_torch/launch/train.py"):
        assert not _hits(_lint_src(tmp_path, R3_BAD, rel), "R3"), rel


# a median elsewhere in the module no longer lets a single-shot value off
R3_MEDIAN_ELSEWHERE = ("import statistics, time\n"
                       "def median_ms(fn):\n"
                       "    return statistics.median(fn() for _ in range(9))\n"
                       "t0 = time.perf_counter()\n"
                       "wall_ms = (time.perf_counter() - t0) * 1e3\n"
                       "assert wall_ms < 5.0\n")
# the smoke's form: a comparison whose body fails the run
R3_IF_FAIL = ("def fail(msg):\n"
              "    raise SystemExit(msg)\n"
              "def gate(rows):\n"
              "    kernel_ms = rows['kernel_ms']\n"
              "    if kernel_ms > 2.0:\n"
              "        fail(f'slow: {kernel_ms}')\n")
# a helper that returns a median, a row built by keyword, read in a gate
R3_FLOW_OK = ("import statistics\n"
              "def median_ms(fn):\n"
              "    return statistics.median(fn() for _ in range(9))\n"
              "def rows(fn):\n"
              "    out = {}\n"
              "    for k in 'ab':\n"
              "        ms = median_ms(fn)\n"
              "        out[k] = dict(ms_per_round=ms)\n"
              "    return out\n"
              "def gate(r):\n"
              "    if r['b']['ms_per_round'] > 1.15 * r['a']['ms_per_round']:\n"
              "        raise AssertionError(f'{r}')\n")


@pytest.mark.parametrize("src,line,names", [
    (R3_MEDIAN_ELSEWHERE, 6, "wall_ms"),
    (R3_IF_FAIL, 5, "kernel_ms"),
    # one single-shot assignment of a key poisons every read of it
    (R3_FLOW_OK + "extra = dict(ms_per_round=0.5)\n", 11, "ms_per_round"),
])
def test_r3_checks_each_value_and_if_fail_gates(tmp_path, src, line, names):
    rel = "chip_smoke.py"
    hits = _hits(_lint_src(tmp_path, src, rel), "R3")
    assert [(h.file, h.line) for h in hits] == [(rel, line)]
    assert f"single-shot timing check on {names}" in hits[0].message
    assert not _hits(_lint_src(tmp_path, R3_FLOW_OK, rel), "R3")


def test_r3_local_names_are_scoped(tmp_path):
    # `out` holds a median in one function and a constant in another:
    # the gate reads the first one's
    src = R3_FLOW_OK + ("def other():\n"
                        "    out = 3\n"
                        "    return out\n")
    assert not _hits(_lint_src(tmp_path, src, "tools/fake.py"), "R3")
    shadow = src + "def gate2(ms):\n    assert ms < 1.0\n"   # a parameter
    hits = _hits(_lint_src(tmp_path, shadow, "tools/fake.py"), "R3")
    assert [h.line for h in hits] == [17] and hits[0].scope == "gate2"


# -- R4: wire sends are billed -------------------------------------------------

@pytest.mark.parametrize("send,name", [
    ("payload, xhat, r = codec.transmit(rows, res, g)", "transmit"),
    ("payload = codec.encode_leaf(rows)", "encode_leaf"),
    ("dist.all_gather_into_tensor(buf, rows)", "all_gather_into_tensor"),
    ("reqs = dist.batch_isend_irecv(ops)", "batch_isend_irecv"),
    ("ops = [dist.P2POp(dist.isend, rows, 1)]", "isend"),
])
def test_r4_unpriced_send_fires(tmp_path, send, name):
    src = f"def round(codec, rows, res, g, dist, buf, ops):\n    {send}\n"
    rel = "src/repro_torch/core/fake_wire.py"
    hits = _hits(_lint_src(tmp_path, src, rel), "R4")
    assert [(h.file, h.line) for h in hits] == [(rel, 2)]
    assert f"({name})" in hits[0].message
    billed = src + ("def bill(topo, p, codec):\n"
                    "    return topo.round_comm_joules(p, codec=codec)\n")
    assert not _hits(_lint_src(tmp_path, billed, rel), "R4")
    replay = src + "E = delivered_comm_joules(base, masks, p)\n"
    assert not _hits(_lint_src(tmp_path, replay, rel), "R4")
    assert not _hits(_lint_src(tmp_path, src,
                               "src/repro_torch/comms/codecs.py"), "R4")


# -- R6: errors name the input -------------------------------------------------

R6_BAD = ("def f(x):\n"
          "    if x < 0:\n"
          "        raise ValueError('x must be >= 0')\n"
          "    return x\n")


@pytest.mark.parametrize("rel", ["src/repro_torch/core/fake.py",
                                 "src/repro_torch/rl/fake.py",
                                 "src/repro_torch/launch/fake.py"])
def test_r6_constant_raise_fires(tmp_path, rel):
    hits = _hits(_lint_src(tmp_path, R6_BAD, rel), "R6")
    assert [(h.file, h.line) for h in hits] == [(rel, 3)]
    named = R6_BAD.replace("'x must be >= 0'",
                           "f'x = {x} must be >= 0; pass abs(x)'")
    assert not _hits(_lint_src(tmp_path, named, rel), "R6")
    bare = R6_BAD.replace("raise ValueError('x must be >= 0')", "raise")
    assert not _hits(_lint_src(tmp_path, bare, rel), "R6")
    nomsg = R6_BAD.replace("ValueError('x must be >= 0')", "ValueError()")
    assert _hits(_lint_src(tmp_path, nomsg, rel), "R6")


def test_r6_scope(tmp_path):
    for rel in ("src/repro_torch/models/fake.py", "chip_smoke.py",
                "tools/fake.py"):
        assert not _hits(_lint_src(tmp_path, R6_BAD, rel), "R6"), rel


def test_syntax_error_is_reported_not_raised(tmp_path):
    out = _lint_src(tmp_path, "def broken(:\n", "src/repro_torch/core/b.py")
    assert [(f.rule, f.line) for f in out] == [("R0", 1)]


# -- the allowlist -------------------------------------------------------------

ALLOW_TOML = """
# comment
[[allow]]
rule = "R4"
file = "src/repro_torch/core/consensus.py"
note = "mechanism layer \\u2014 callers bill"
added_in = 21

[other_table]
rule = "IGNORED"

[[allow]]
rule = "R1"
file = "*"
match = "_round_keys"
note = "tracked"
added_in = 20
"""


def test_parse_allowlist_subset():
    entries = parse_allowlist(ALLOW_TOML)
    assert [e["rule"] for e in entries] == ["R4", "R1"]
    assert entries[1]["match"] == "_round_keys"
    assert entries[0]["added_in"] == 21
    note = parse_allowlist('[[allow]]\nrule = "X"\nfile = "*"\n'
                           'note = "em — dash"\nadded_in = 1\n')
    assert note[0]["note"] == "em — dash"


@pytest.mark.parametrize("src,needle", [
    # the JAX package's rejection cases, ported
    ('[[allow]]\nrule = "R4" trailing\n', "line 2"),
    ('[[allow]]\nrule = "unterminated\n', "line 2"),
    ('rule = "R4"\n', "outside any table"),
    ('[[allow]]\njust a line\n', "line 2"),
    ('[bad header!]\nrule = "R4"\n', "line 1"),
    ('[[allow]]\nrule = naked\n', "line 2"),
    # unknown keys, types and duplicates
    ('[[allow]]\nrule = "R4"\nfiel = "x.py"\n', "line 3: unknown key 'fiel'"),
    ('[[allow]]\nrule = "R4"\nadded_in = "21"\n', "line 3: added_in"),
    ('[[allow]]\nrule = 4\n', "line 2: rule = 4 is a int"),
    ('[[allow]]\nrule = "R4"\nadded_in = 2.5\n', "line 3"),
    ('[[allow]]\nrule = "R4"\nfile = "a"\nrule = "R6"\n',
     "line 4: duplicate key 'rule'.*line 2"),
    # a missing required key names the entry's header line
    ('\n[[allow]]\nrule = "R4"\nfile = "a"\nnote = "n"\n',
     "line 2: .* no added_in"),
    ('[[allow]]\nrule = "R4"\nfile = "a"\nadded_in = 1\n[[allow]]\n',
     "line 1: .* no note"),
])
def test_parse_allowlist_rejects_malformed_entries(src, needle):
    with pytest.raises(ValueError, match=needle):
        parse_allowlist(src)


def test_apply_allowlist_rule_file_match():
    entries = parse_allowlist(ALLOW_TOML)
    fs = [Finding("R4", "src/repro_torch/core/consensus.py", 1, "isend"),
          Finding("R4", "chip_smoke.py", 2, "isend"),
          Finding("R1", "src/repro_torch/core/topology.py", 3,
                  "prng.fold_in() in _round_keys()"),
          Finding("R1", "src/repro_torch/core/topology.py", 4,
                  "prng.fold_in() in other()")]
    out = apply_allowlist(fs, entries)
    assert [f.allowlisted for f in out] == [True, False, True, False]
    assert "callers bill" in out[0].note


def test_stale_entries_dedup_and_file_matches():
    entries = [{"rule": "R4", "file": "a.py", "added_in": 17},
               {"rule": "R1", "file": "b.py", "added_in": 20},
               {"rule": "R6", "file": "c.py"}]
    out = stale_entries(entries, current_pr=21, stale_after=4)
    assert [e["rule"] for e, _w in out] == ["R4", "R6"]
    assert "4 PRs old" in out[0][1] and "undated" in out[1][1]
    a, b = Finding("R1", "x.py", 3, "m"), Finding("R1", "x.py", 3, "m")
    c, d = Finding("R1", "x.py", 4, "m"), Finding("R6", "y", 0, "n")
    assert dedup_findings([a, d, b, c]) == [a, d, c]
    assert _file_matches("src/repro_torch/core/consensus.py", "consensus.py")
    assert _file_matches("anything", "*")
    assert not _file_matches("src/repro_torch/core/not_consensus.py",
                             "/consensus.py")


# -- the baseline --------------------------------------------------------------

def test_json_and_sarif_baseline_round_trip(tmp_path):
    fs = [Finding("R4", "src/repro_torch/core/consensus.py", 3, "isend",
                  allowlisted=True, note="tracked", scope="step"),
          Finding("R4", "src/repro_torch/core/consensus.py", 7, "isend",
                  allowlisted=True, note="tracked", scope="Engine.gather")]
    p = tmp_path / "base.json"
    p.write_text(findings_to_json(fs))
    base = load_baseline(str(p))
    assert sorted(base.elements()) == sorted(finding_key(f) for f in fs)
    assert new_findings(fs, base) == []
    moved = dataclasses.replace(fs[0], line=99)
    assert new_findings([moved, fs[1]], base) == []   # lines drift freely
    # a new site under the same file-wide allowlist entry is new: in
    # another function, or a second one in a baselined function
    elsewhere = dataclasses.replace(fs[0], line=40, scope="other")
    again = dataclasses.replace(fs[0], line=5)
    assert new_findings(fs + [elsewhere, again], base) == [elsewhere, again]
    opened = Finding("R1", "src/repro_torch/rl/y.py", 1, "draw")
    assert new_findings(fs + [opened], base) == [opened]  # open: always
    log = json.loads(findings_to_sarif(fs + [opened]))
    assert log["version"] == "2.1.0"
    res = log["runs"][0]["results"]
    assert [r["level"] for r in res] == ["note", "note", "error"]
    assert [(r["ruleId"], r["locations"][0]["physicalLocation"]["region"]
             ["startLine"], r["locations"][0]["physicalLocation"]
             ["artifactLocation"]["uri"], r["locations"][0]
             ["logicalLocations"][0]["fullyQualifiedName"]) for r in res] == [
        (f.rule, f.line, f.file, f.scope) for f in fs + [opened]]
    assert {r["id"] for r in log["runs"][0]["tool"]["driver"]["rules"]} \
        == {"R4", "R1"}
    p.write_text('{"not": "a list"}')
    with pytest.raises(ValueError, match="regenerate"):
        load_baseline(str(p))
    p.write_text('[{"rule": "R6"}]')
    with pytest.raises(ValueError, match="entry 0"):
        load_baseline(str(p))
    # a refreshed baseline cannot absorb an open finding
    p.write_text(findings_to_json(fs + [opened]))
    with pytest.raises(ValueError, match="entry 2 .*open finding"):
        load_baseline(str(p))


def test_cli_gates_new_findings_only(tmp_path, capsys):
    root = tmp_path / "tree"
    core = root / "src" / "repro_torch" / "core"
    core.mkdir(parents=True)
    (core / "old.py").write_text(R6_BAD)
    allow = tmp_path / "allow.toml"
    allow.write_text('[[allow]]\nrule = "R6"\nfile = "core/old.py"\n'
                     'note = "tracked"\nadded_in = 21\n')
    base, out = tmp_path / "base.json", tmp_path / "out.json"
    common = ["--root", str(root), "--allowlist", str(allow), "--layer",
              "lint"]
    assert main(common + ["--format", "json", "--json-out", str(base)]) == 0
    assert main(common + ["--strict"]) == 0           # allowlisted
    assert main(common + ["--strict", "--baseline", str(base),
                          "--json-out", str(out)]) == 0
    assert out.read_text() == base.read_text()
    # a second site under the file-wide entry: --strict alone lets it
    # through, the baseline does not
    (core / "old.py").write_text(R6_BAD + R6_BAD.replace("def f", "def g"))
    assert main(common + ["--strict"]) == 0
    capsys.readouterr()
    assert main(common + ["--strict", "--baseline", str(base)]) == 1
    err = capsys.readouterr().err
    assert "1 NEW finding" in err and "src/repro_torch/core/old.py:7" in err
    (core / "old.py").write_text(R6_BAD)
    (core / "new.py").write_text(R6_BAD.replace("x must", "y must"))
    capsys.readouterr()
    assert main(common + ["--strict", "--baseline", str(base)]) == 1
    err = capsys.readouterr().err
    assert "1 NEW finding" in err and "src/repro_torch/core/new.py:3" in err
    assert main(common + ["--baseline", str(base)]) == 0   # report only
    capsys.readouterr()
    assert main(common + ["--format", "sarif"]) == 0
    sarif = json.loads(capsys.readouterr().out)
    assert len(sarif["runs"][0]["results"]) == 2
    # refreshing the baseline from a tree with an open finding is refused
    assert main(common + ["--format", "json", "--json-out", str(base)]) == 0
    with pytest.raises(ValueError, match="open finding"):
        main(common + ["--strict", "--baseline", str(base)])


# -- the live tree ---------------------------------------------------------------

def test_live_tree_is_clean():
    findings = run_lint(str(ROOT))
    entries = load_allowlist(str(PKG / "allowlist.toml"))
    open_f = [f for f in apply_allowlist(findings, entries)
              if not f.allowlisted]
    assert open_f == [], "\n".join(f.format() for f in open_f)
    walked = {f.file for f in findings}
    assert "src/repro_torch/core/consensus.py" in walked
    assert all(e.get("note") and isinstance(e.get("added_in"), int)
               for e in entries)
    # every entry covers a finding: no allowlisted debt outlives its code
    for e in entries:
        fresh = [Finding(f.rule, f.file, f.line, f.message) for f in findings]
        assert any(f.allowlisted for f in apply_allowlist(fresh, [e])), e
    assert main(["--strict", "--baseline", str(PKG / "baseline.json"),
                 "--device", "cpu"]) == 0
    assert main(["--strict", "--layer", "lint"]) == 0
