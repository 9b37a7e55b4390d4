"""The port's cost-model layer (``repro_torch.analysis.costmodel``), case
for case against the JAX package's C-layer tests (``tests/
test_analysis.py``): C2 fires on an overpriced (and an idle) round and an
empty count is an allowlisted skip; C3 classifies priced, control-plane
and unpriced collectives; C1 fires on mispriced bits, its static rows
replay the chaos convention and equal the JAX package's rows, and every
plan x codec (async included) reconciles ``==``; C1a brackets the bytes a
real gloo group of 4 processes ships, where the recorder sees the
distributed plan's p2p sends, and the meshed FL driver's observer
collectives (population gather, disagreement all-reduces) land on their
own ledger line while a stray f32 gather is still a C3 finding;
``audit_meta()`` equals the JAX engine's without a mesh. One gloo spawn
(4 ranks)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.analysis import costmodel as jcm  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch.analysis import costmodel as cm  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402

#: the JAX plan names and HLO collectives, in the port's terms
PLANS = {"dense-xla": "dense", "sparse-pallas": "sparse",
         "sharded": "sharded", "distributed": "distributed"}
WIRES = {None: None, "all-gather": ("_allgather_base_",),
         "collective-permute": ("send", "recv_")}


def _rec(kind, dtype, shape):
    """A recorded collective of one tensor (what the recorder makes)."""
    t = torch.zeros(shape, dtype=dtype)
    return cm.Collective(kind, f"{dtype}{list(shape)}",
                         t.numel() * t.element_size(),
                         frozenset({str(dtype).replace("torch.", "")}))


# -- C2 ------------------------------------------------------------------------

def test_c2_overpriced_round_fires():
    expected = 20736.0
    bad = expected * cm.C2_RATIO + cm.C2_SLACK_FLOPS + 1
    hits = cm.check_round_flops(bad, expected, "rl:case-study")
    assert len(hits) == 1 and hits[0].rule == "C2"
    assert "compute model" in hits[0].message
    # and the lower bracket: a round doing almost no work is as wrong
    assert cm.check_round_flops(expected / cm.C2_RATIO - 1, expected, "x")
    assert cm.check_round_flops(expected * 1.02, expected, "x") == []


def test_c2_unmeasurable_round_is_allowlisted_skip():
    hits = cm.check_round_flops(None, 100.0, "rl:case-study")
    assert len(hits) == 1 and hits[0].allowlisted
    assert "skipped" in hits[0].message


def test_c2_case_study_round_counts_2k2n():
    """The dense round at the case-study shape: FlopCounterMode counts
    exactly 2·K²·N per leaf, so the audit is clean; the JAX package's
    counter on the same round agrees within C2's bracket too."""
    from torch.utils.flop_counter import FlopCounterMode
    assert cm.audit_round_flops() == []
    eng = ConsensusEngine(topology.ring(12), plan="dense")
    counter = FlopCounterMode(display=False)
    with counter:
        eng.step({"w0": torch.zeros(12, 64), "w1": torch.zeros(12, 8)})
    assert counter.get_total_flops() == 2 * 12 * 12 * (64 + 8)
    assert jcm.audit_round_flops() == []


# -- C3 ------------------------------------------------------------------------

C3_META = {"plan": "sharded", "codec": "int8", "K": 8,
           "priced_collectives": {"_allgather_base_": {"SL": 8}}}
C3_RECORDS = [_rec("_allgather_base_", torch.int8, (8, 1, 16)),   # wire
              _rec("_allgather_base_", torch.float32, (8, 1)),    # scales
              _rec("allreduce_", torch.uint32, (16,)),            # rng
              _rec("send", torch.float32, (8, 64))]               # leak


def test_c3_unpriced_collective_fires_and_ledger_classifies():
    ledger, findings = cm.collective_ledger(C3_META, C3_RECORDS,
                                            "engine:fake")
    assert ledger.priced_bytes == {"_allgather_base_": 128 + 32}
    assert ledger.control_bytes == 64          # u32 RNG plane
    assert ledger.unpriced_bytes == 8 * 64 * 4
    assert len(findings) == 1 and findings[0].rule == "C3"
    assert "send" in findings[0].message
    assert "outside the" in findings[0].message


def test_c3_empty_meta_prices_nothing():
    ledger, findings = cm.collective_ledger({}, C3_RECORDS, "prog:fake")
    assert ledger.priced_bytes == {}
    # without a K, only dtype-control transfers stay silent
    assert [f.rule for f in findings] == ["C3", "C3", "C3"]


def test_c3_drivers_ship_no_payload():
    """The chunked drivers run in one process: no collective at all, and
    a seeded payload collective in a driver's records fires."""
    drivers = cm._tiny_drivers()
    assert [n for n, _ in drivers] == ["driver:scan_rounds",
                                       "driver:run_fl_until_scan",
                                       "driver:maml_train_scan"]
    assert all(records == [] for _, records in drivers)
    assert cm.audit_registered_collectives(drivers) == []
    hits = cm.audit_registered_collectives(
        [("driver:seeded", [_rec("allreduce_", torch.float32, (4, 64))])])
    assert len(hits) == 1 and hits[0].rule == "C3"


# -- C1 ------------------------------------------------------------------------

def _chaos_engine(plan="dense", codec="int8:b64", k=6, package="port",
                  **kw):
    topo_mod, cls = ((topology, ConsensusEngine) if package == "port"
                     else (jtopo, JEngine))
    return cls(topo_mod.ring(k), codec=codec, plan=plan,
               graph=topo_mod.GraphProcess.dropout(0.3, seed=2),
               agents=topo_mod.AgentProcess.bernoulli(0.6, seed=5),
               tau=2, staleness_decay=0.9, **kw)


def test_c1_mispriced_bits_fire():
    eng = _chaos_engine()
    hits = cm.reconcile_engine_run(eng, rounds=2, label="engine:seeded",
                                   expected_bits=1.0)   # absurd pricing
    assert hits and all(f.rule == "C1" for f in hits)
    assert any("wire bits" in f.message for f in hits)


def test_c1_static_rows_replay_chaos_convention():
    """A wire bills iff its link survived AND both endpoints were awake,
    row by row; and the rows equal the JAX package's static rows."""
    eng = _chaos_engine()
    rows = cm.static_round_counts(eng, 4)
    adjs = topology.dropout(eng.topology, 0.3, seed=2, rounds=4)
    acts = np.asarray(topology.availability_stream(eng.agents, 6, 4), bool)
    for t, row in enumerate(rows):
        m = (np.asarray(adjs[t].adjacency, bool)
             & acts[t][:, None] & acts[t][None, :])
        assert row["n_sl"] + row["n_ul"] + row["n_dl"] == int(m.sum())
        assert row["n_active"] == int(acts[t].sum())
    want = jcm.static_round_counts(
        _chaos_engine("dense-xla", package="jax"), 4)
    assert rows == want


def test_c1_ledger_reconciles_all_plans_and_codecs():
    """Acceptance: C1b reconciles ``==`` for all four plans x {f32,
    int8:b64}, async configs included."""
    findings = cm.audit_ledger_reconciliation()
    assert findings == [], "\n".join(f.format() for f in findings)


def test_c1a_bracket_fires_both_ways():
    priced = {"_allgather_base_": {"SL": 8}}
    assert cm.check_wire_bytes(272, 272.0, "x", priced) == []
    assert cm.check_wire_bytes(int(272 * cm.C1_RATIO) + cm.C1_SLACK_BYTES,
                               272.0, "x", priced) == []
    low = cm.check_wire_bytes(271, 272.0, "engine:seeded", priced)
    assert len(low) == 1 and "never moves" in low[0].message
    high = cm.check_wire_bytes(4 * 272, 272.0, "engine:seeded", priced)
    assert len(high) == 1 and "more than the codec" in high[0].message
    assert cm.check_wire_bytes(0, None, "x", priced) == []


@pytest.fixture(scope="module")
def mesh_rows():
    """One spawn of 4 gloo ranks: a masked round and the meshed FL driver
    of each plan x codec, recorded on every rank."""
    return cm.run_mesh_rounds(4)


def test_mesh_ledgers_on_a_gloo_group_of_4(mesh_rows):
    """C1a + C3 on 4 spawned gloo processes: the recorder sees the
    sharded plan's all-gathers and the distributed plan's p2p sends and
    receives; every rank's shipped priced bytes lie in the bracket; a
    seeded extra payload collective and a seeded mispricing fire."""
    rows = [r for r in mesh_rows if r["driver"] is None]
    assert len(rows) == 4 * len(cm.MESH_CASES)
    for row in rows:
        kinds = {r.kind for r in row["records"]}
        if row["plan"] == "distributed":
            assert kinds == {"send", "recv_"}, row
            sends = sum(r.nbytes for r in row["records"]
                        if r.kind == "send")
            recvs = sum(r.nbytes for r in row["records"]
                        if r.kind == "recv_")
            assert sends == recvs == row["expected"] > 0
        else:
            assert kinds == {"_allgather_base_"}, row
        ledger, c3 = cm.collective_ledger(row["meta"], row["records"], "x")
        assert c3 == [] and ledger.unpriced_bytes == 0
        assert (row["expected"] <= ledger.wire_bytes
                <= row["expected"] * cm.C1_RATIO + cm.C1_SLACK_BYTES)
    assert cm.audit_mesh_ledgers(rows) == []
    leak = dict(rows[0], records=rows[0]["records"]
                + [_rec("allreduce_", torch.float32, (4, 64))])
    assert [f.rule for f in cm.audit_mesh_ledgers([leak])] == ["C3"]
    mispriced = dict(rows[0], expected=2 * rows[0]["expected"])
    assert [f.rule for f in cm.audit_mesh_ledgers([mispriced])] == ["C1"]


def test_meshed_drivers_book_their_observer_collectives(mesh_rows):
    """The meshed ``run_fl_until_scan`` (2 rounds, every round evaluated,
    buffered telemetry) on 4 gloo ranks: besides the plan's wire, each
    rank ships exactly the observer collectives ``audit_meta()`` names —
    one population gather (K agents' bytes) and the disagreement's two
    all-reduces a round — which C3 books on their own ledger line and not
    in the priced bytes; the wire bytes are the round's times the rounds
    (C1a); the audit is clean. A stray f32 gather in a meshed round, by
    the observer's op or by the wire's, is still a C3 finding."""
    rows = [r for r in mesh_rows if r["driver"] is not None]
    assert len(rows) == 4 * len(cm.MESH_CASES)
    R = cm.MESH_DRIVER_ROUNDS
    for row in rows:
        meta = row["meta"]
        obs = {o["quantity"]: o for o in meta["observer_collectives"]}
        assert set(obs) == {"population for target_fn",
                            "disagreement column sums",
                            "disagreement distances",
                            "logged loss of agent 0"}
        # the FL driver logs no loss: train_federated's broadcast
        assert obs.pop("logged loss of agent 0") == dict(
            op="broadcast_", quantity="logged loss of agent 0", bytes=4)
        assert obs["population for target_fn"]["op"] == "allgather_"
        # K = 4 agents of one (64,) f32 leaf
        assert obs["population for target_fn"]["bytes"] == 4 * 64 * 4
        assert obs["disagreement column sums"]["bytes"] == 64 * 4
        assert obs["disagreement distances"]["bytes"] == 4 * 4
        ledger, c3 = cm.collective_ledger(meta, row["records"], "x",
                                          row["observer_calls"])
        assert c3 == [] and ledger.unpriced_bytes == 0
        assert ledger.control_bytes == 0
        assert ledger.observer_bytes == {q: R * o["bytes"]
                                         for q, o in obs.items()}
        assert ledger.observer_calls == {q: R for q in obs}
        wire = set(meta["priced_collectives"])
        assert set(ledger.priced_bytes) == wire
        assert ledger.wire_bytes == row["expected"] > 0
        kinds = [r.kind for r in row["records"]]
        assert kinds.count("allgather_") == R
        assert kinds.count("allreduce_") == 2 * R
    assert cm.audit_mesh_ledgers(rows) == []
    assert all(r["observer_calls"] == cm.observer_calls(R, R) for r in rows)
    for row in rows[:2]:                       # a sharded and its int8 twin
        for kind in ("allgather_", "_allgather_base_"):
            stray = _rec(kind, torch.float32, (4, 65))
            leak = dict(row, records=row["records"] + [stray])
            hits = cm.audit_mesh_ledgers([leak])
            if kind == "_allgather_base_":     # the sharded wire's op
                assert [f.rule for f in hits] == ["C1"]
            else:
                assert [f.rule for f in hits] == ["C3"]
                assert "allgather_" in hits[0].message
    for row in rows:
        if row["plan"] == "distributed":
            stray = _rec("_allgather_base_", torch.float32, (4, 64))
            hits = cm.audit_mesh_ledgers([dict(row, records=row["records"]
                                               + [stray])])
            assert [f.rule for f in hits] == ["C3"]
            break


def test_observer_calls_past_their_count_are_findings(mesh_rows):
    """C3 books an observer collective only up to the calls the audited run
    makes of it: an f32 all-reduce of the column sums' 4·N bytes (what a
    FedAvg-style model average would ship) or a second population gather
    in a bare meshed round, which makes none, or one past a driver run's
    count, is a finding; so is an observer call the records lack."""
    def rules(row, records):
        return [f.rule for f in cm.audit_mesh_ledgers(
            [dict(row, records=records)])]

    R = cm.MESH_DRIVER_ROUNDS
    for row in mesh_rows:
        obs = {o["quantity"]: o for o in row["meta"]["observer_collectives"]}
        avg = _rec("allreduce_", torch.float32, (64,))
        assert avg.nbytes == obs["disagreement column sums"]["bytes"]
        gather = _rec("allgather_", torch.uint8,
                      (obs["population for target_fn"]["bytes"],))
        for stray in (avg, gather):
            hits = cm.audit_mesh_ledgers([dict(row, records=row["records"]
                                               + [stray])])
            assert [f.rule for f in hits] == ["C3"], (row["driver"], hits)
            assert (f"past the {R if row['driver'] else 0} call(s)"
                    in hits[0].message), hits
        if row["driver"] is not None:
            i = next(j for j, r in enumerate(row["records"])
                     if r.kind == "allgather_")
            assert rules(row, row["records"][:i] + row["records"][i + 1:]) \
                == ["C3"]
    bare = next(r for r in mesh_rows if r["driver"] is None)
    assert cm.audit_mesh_ledgers(
        [dict(bare, observer_calls=cm.observer_calls(1, 0))])[0].rule == "C3"


def test_audit_meta_names_observers_only_on_a_mesh(tmp_path):
    """Without a mesh the drivers ship nothing, so ``audit_meta()`` names
    no observer collective (and keeps the JAX package's keys); on a
    1-position gloo mesh it names the four, with bytes for the agents
    given."""
    from repro_torch.launch import mesh as mesh_lib
    assert "observer_collectives" not in ConsensusEngine(
        topology.ring(8), plan="sharded", num_blocks=2).audit_meta()
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"))
    try:
        eng = ConsensusEngine(topology.ring(8), plan="sharded",
                              mesh=mesh_lib.make_agent_mesh())
        agent = {"w": torch.zeros(5, 3), "b": torch.zeros(2,
                                                          dtype=torch.bfloat16)}
        obs = eng.audit_meta(agent)["observer_collectives"]
        assert [(o["op"], o["bytes"]) for o in obs] == [
            ("allgather_", 8 * (15 * 4 + 2 * 2)), ("allreduce_", 17 * 4),
            ("allreduce_", 8 * 4), ("broadcast_", 4)]
        assert eng.audit_meta()["observer_collectives"][0]["bytes"] is None
    finally:
        mesh_lib.destroy_local_group()


# -- audit_meta ------------------------------------------------------------------

@pytest.mark.parametrize("codec", [None, "int8", "int4:b64"])
@pytest.mark.parametrize("jplan", list(PLANS))
def test_audit_meta_matches_jax(jplan, codec):
    kw = {"num_blocks": 2} if jplan == "sharded" else {}
    want = JEngine(jtopo.ring(4), codec=codec, plan=jplan,
                   **kw).audit_meta()
    got = ConsensusEngine(topology.ring(4), codec=codec, plan=PLANS[jplan],
                          **kw).audit_meta()
    wire = WIRES[want["wire_collective"]]
    want = dict(want, plan=PLANS[jplan], wire_collective=wire,
                priced_collectives={op: want["link_classes"]
                                    for op in wire or ()})
    assert got == want


def test_audit_meta_exposes_priced_collectives():
    eng = ConsensusEngine(topology.ring(4), codec="int8", plan="sharded",
                          num_blocks=2)
    meta = eng.audit_meta()
    assert meta["wire_collective"] == ("_allgather_base_",)
    assert set(meta["priced_collectives"]) == {"_allgather_base_"}
    classes = meta["priced_collectives"]["_allgather_base_"]
    assert classes == meta["link_classes"]
    assert sum(classes.values()) == sum(
        eng.topology.links_per_round().values())
