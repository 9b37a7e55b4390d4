"""The scale benchmark's twin (``repro_torch.launch.consensus_scale``)
against the JAX package's ``benchmarks/consensus_scale.py`` (loaded by
path, unchanged), on the CPU.

The twin's ``--smoke`` sections run here at their smoke sizes; what they
price is exact and must equal the reference functions' values for the
same rows (``==``): Eq.-(11) joules per round, link counts by class and
wire bits per model. Their timings are host-clock numbers of this CPU and
are not gated here: the ``--smoke`` timing gates run on the card
(``chip_smoke.py``, phase ``mesh`` (f)). The floor rule is checked on
rows made up for it.
"""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import comms as jcomms  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch.core import consensus  # noqa: E402
from repro_torch.launch import consensus_scale as cs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_bench():
    """``benchmarks/consensus_scale.py`` as a module, by its path."""
    spec = importlib.util.spec_from_file_location(
        "_ref_consensus_scale", ROOT / "benchmarks" / "consensus_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clock():
    return cs.Clock("cpu")


def _ref_wire(spec, full_bits):
    codec = jcomms.resolve_codec(spec) if spec is not None else None
    return codec.price_bits(full_bits) if codec is not None \
        else float(full_bits)


def test_smoke_codec_and_sharded_rows_price_like_reference(clock):
    p_cal = jen.paper_calibrated("fig3")
    full_bits = cs.N_PARAMS * 32
    for rows, plan in ((cs.codec_sweep(clock, (64,), ("ring",), ("int8",)),
                        "auto"),
                       (cs.sharded_rows(clock, (64,), ("ring",), ("int8",),
                                        num_blocks=4), "sharded")):
        assert len(rows) == 1
        r = rows[0]
        kw = {"num_blocks": 4} if plan == "sharded" else {}
        jeng = JEngine(jtopo.ring(64), codec="int8", plan=plan, **kw)
        assert r["joules_eq11_per_round"] == jeng.round_comm_joules(
            p_cal, model_bits=full_bits)
        assert r["wire_bits_per_model"] == _ref_wire("int8", full_bits)
        assert r["codec"] == jeng.codec.name == "int8+ef"
        assert r["us_per_round"] > 0
    assert rows[0]["plan"] == "sharded" and rows[0]["num_blocks"] == 4


def test_casestudy_eq11_equals_reference(ref_bench):
    specs = (None, "bf16", "int8", "int4", "topk:0.05")
    ours, theirs = cs.casestudy_eq11(specs), ref_bench.casestudy_eq11(specs)
    assert ours == theirs
    assert ours["int8+ef"]["drop_vs_uncompressed"] >= 3.0      # the gate


def test_sweep_rows_links_and_joules_equal_reference(clock):
    p_cal = jen.paper_calibrated("fig3")
    rows = cs.sweep(clock, (12,), ("ring", "cluster", "star"),
                    ("float32", "bfloat16"), n_params=(64,))
    assert {r["impl"] for r in rows} == {"dense", "auto", "sparse"}
    for r in rows:
        jt = jtopo.make(r["topology"], r["K"])
        assert r["links"] == jt.links_per_round()
        assert r["max_degree"] == jt.max_degree
        bits = 64 * (4 if r["dtype"] == "float32" else 2) * 8
        assert r["model_bits"] == bits
        assert r["joules_eq11_per_round"] == jt.round_comm_joules(
            p_cal, model_bits=bits)
    # the forced sparse rows appear only where the degree test lets the
    # gather run (not on the star)
    assert not [r for r in rows if r["impl"] == "sparse"
                and r["topology"] == "star"]


def test_smoke_loop_sections_run(clock, ref_bench):
    """The timed loop sections at their smoke sizes, with the reference's
    row keys (so the two JSON files diff key for key)."""
    loop = cs.rounds_loop_rows(clock, chunks=(1, 32), rounds=64)
    drop = cs.dropout_rows(clock, rounds=16, configs=(
        ("cluster", cs.topo_lib.clusters(6, 2), "dense"),))
    tel = cs.telemetry_rows(clock, rounds=64, chunk=16)
    mask = cs.mask_scale_rows(clock, ks=(256,), min_speedup_at_4096=None)
    asy = cs.async_rows(clock, rounds=16, configs=(
        ("cluster", cs.topo_lib.clusters(6, 2), "dense"),))
    assert [r["chunk"] for r in loop] == [1, 32]
    assert [r["telemetry"] for r in tel] == ["off", "buffered", "streaming"]
    assert [r["mode"] for r in drop] == ["in-scan", "host-prefetch"]
    assert [r["mode"] for r in mask] == ["per-lane", "kk-rebuild"]
    assert [r["mode"] for r in asy] == ["lockstep", "staleness"]
    keys = {  # the reference's row keys, section by section
        "rounds_loop": {"K", "topology", "n_params", "local_steps", "rounds",
                        "chunk", "driver", "us_per_round",
                        "speedup_vs_host_loop"},
        "dropout_rows": {"K", "topology", "plan", "dropout_p", "rounds",
                         "mode", "us_per_round", "speedup_vs_host_prefetch"},
        "telemetry_rows": {"K", "topology", "n_params", "chunk", "rounds",
                           "telemetry", "us_per_round", "overhead_vs_off"},
        "mask_scale_rows": {"K", "topology", "plan", "dropout_p", "n_params",
                            "mode", "us_per_round", "speedup_vs_kk_rebuild"},
        "async_rows": {"K", "topology", "plan", "rounds", "mode",
                       "us_per_round", "overhead_vs_lockstep"},
    }
    for name, rows in (("rounds_loop", loop), ("dropout_rows", drop),
                       ("telemetry_rows", tel), ("mask_scale_rows", mask),
                       ("async_rows", asy)):
        for r in rows:
            assert set(r) == keys[name], name
            assert r["us_per_round"] > 0
    # the same sizes as the reference's own --smoke
    assert ref_bench.ROUNDS_LOOP_CHUNKS == cs.ROUNDS_LOOP_CHUNKS
    assert ref_bench.SHARDED_KS == cs.SHARDED_KS
    assert ref_bench.MASK_SCALE_KS == cs.MASK_SCALE_KS


def test_cluster_engine_rows_and_floor_rule(clock):
    rows = cs.cluster_engine_rows(clock)
    assert [r["impl"] for r in rows] == ["dense", "sparse", "auto"]
    assert all(r["K"] == 2 and r["k_times_h"] == 2 and r["leaves"] == 10
               for r in rows)
    # auto keeps K = 2 dense under the port's floor (K·H = 2 < 24)
    assert rows[-1]["plan"] == "dense"

    def row(kh, speedup, dtype="float32", impl="sparse"):
        return dict(K=kh, topology="ring", n_params=8, k_times_h=kh,
                    dtype=dtype, impl=impl, speedup_vs_xla=speedup)

    made = [row(512, 1.4), row(12, 0.6), row(256, 1.2), row(128, 0.8),
            row(64, 1.1, dtype="bfloat16"), row(24, 2.0, impl="auto")]
    got = cs.floor_from_rows(made)
    assert got["floor"] == 256 and got["rows"] == 4
    assert [r["k_times_h"] for r in got["losses"]] == [12, 128]
    assert cs.floor_from_rows([])["floor"] is None
    # the port's floor is what the card's rows gave (PERF.md)
    assert consensus.SPARSE_GATHER_FLOOR == 24


def test_cli_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        cs.main(["--smoke", "--device", "cuda"])


def test_run_writes_the_payload(tmp_path, monkeypatch):
    """``run`` writes every section of the reference plus the twin's own
    (the sections' timings stubbed: this checks the assembly)."""
    for name in ("codec_sweep", "sharded_rows", "rounds_loop_rows",
                 "dropout_rows", "telemetry_rows", "mask_scale_rows",
                 "async_rows", "sweep", "cluster_engine_rows"):
        monkeypatch.setattr(cs, name, lambda *a, **k: [
            {"us_per_round": 1.0, "overhead_vs_off": 1.0}] * 3)
    out = tmp_path / "scale.json"
    payload = cs.run(smoke=True, device="cpu", out=str(out))
    data = json.loads(out.read_text())
    for key in ("rows", "codec_rows", "sharded_rows", "casestudy_eq11",
                "rounds_loop", "dropout_rows", "telemetry_rows",
                "mask_scale_rows", "async_rows", "cluster_engine_rows",
                "floor", "n_params_per_agent", "ks", "families", "dtypes"):
        assert key in data, key
    assert data["smoke"] is True and data["timer"] == "host_clock"
    assert data["device"]["platform"] == "cpu"
    assert payload["casestudy_eq11"] == data["casestudy_eq11"]
    assert data["sparse_gather_floor"] == consensus.SPARSE_GATHER_FLOOR
