"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's, and its own contracts.

Against JAX: ``ConsensusEngine.scan_rounds(telemetry=)`` on the same
numpy-made params, K = 16, over {ring, small_world} × {dense, sparse} ×
{static, links fading with p = 0.3, agents awake with p = 0.6 (τ = 3,
λ = 0.9)} × {None, int8}. The integer fields of every row (link counts by
class, n_active, max_age, the per-sender ``agent_*`` lists) depend only on
the draws, which are bit-exact between the packages, so they and the
float64 joules priced from them must be equal (``==``). Disagreement is
held within rel 1e-5 (the packages sum leaves in other orders); with the
int8 wire only on the first round, since from the second round on an f32
ulp may flip an int8 lane by a quantizer step.

Within the port: telemetry off, buffered and streaming give the same
bits and the same buffers, with one device→host read per chunk (buffered)
or one more per round (streaming); sinks see live rounds only; a
mid-chunk hit gives exactly t_i live FL events; a sleeping agent bills
exactly 0.0; static per-agent rows are the link-class table; the schema,
sinks, buffer and refusals; and the case study at a tiny width, whose
streamed joules equal its post-hoc bill under dropout."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtl  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch import telemetry as tl  # noqa: E402
from repro_torch.core import federated, scanloop, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.telemetry import schema  # noqa: E402

K = 16
PLANS = {"dense": "dense-xla", "sparse": "sparse-pallas"}
#: fields that depend only on the draws: equal between the packages
EXACT = ("type", "driver", "round", "live", "reached", "metric", "K",
         "topology", "n_sl", "n_ul", "n_dl", "edges", "n_active", "max_age",
         "agent_sl", "agent_ul", "agent_dl", "wire_bits", "joules_sl",
         "joules_ul", "joules_dl", "joules", "agent_joules")


def _params(seed=0, K=K):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 40)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def _t(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


def _process(mod, name):
    if name == "dropout":
        return dict(graph=mod.GraphProcess.dropout(0.3, seed=1))
    if name == "bernoulli":
        return dict(agents=mod.AgentProcess.bernoulli(0.6, seed=2), tau=3,
                    staleness_decay=0.9)
    return {}


def _topo(mod, graph):
    return mod.ring(K) if graph == "ring" else mod.small_world(K, k=4, seed=1)


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("process", ["static", "dropout", "bernoulli"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
@pytest.mark.parametrize("graph", ["ring", "small_world"])
def test_scan_rounds_rows_match_jax(graph, plan, process, codec):
    eng = ConsensusEngine(_topo(topology, graph), codec=codec, plan=plan,
                          **_process(topology, process))
    jeng = JEngine(_topo(jtopo, graph), codec=codec, plan=PLANS[plan],
                   **_process(jtopo, process))
    p = _params(1)
    tel, jtel = tl.Telemetry(), jtl.Telemetry()
    eng.scan_rounds(_t(p), rounds=3, t0=1, telemetry=tel)
    jeng.scan_rounds({k: jnp.asarray(v) for k, v in p.items()}, rounds=3,
                     t0=1, telemetry=jtel)
    ev, jev = tel.events(), jtel.events()
    assert [e["round"] for e in ev] == [1, 2, 3]
    assert len(ev) == len(jev)
    for i, (e, je) in enumerate(zip(ev, jev)):
        for f in EXACT:
            assert e[f] == je[f], (f, i)
        if codec is None or i == 0:
            np.testing.assert_allclose(e["disagreement"], je["disagreement"],
                                       rtol=1e-5, err_msg=f"round {i}")
    if process != "static":                  # the draws really vary
        assert len({e["edges"] for e in ev}) > 1 or \
            len({e["n_active"] for e in ev}) > 1
    assert tel.joules(driver="consensus") == jtel.joules(driver="consensus")


# -- within the port: modes, reads, freezes -------------------------------------

KF, D = 6, 8


def _fl_loss(p, b):
    pred = b["x"] @ p["w"] + p["b"]
    return ((pred - b["y"]) ** 2).mean()


_X = np.random.default_rng(3).standard_normal((40, KF, 1, 4, D)).astype(
    np.float32)


def _fl_sample(_generator, t):
    x = torch.from_numpy(_X[t])
    return {"x": x, "y": x.sum(-1, keepdim=True)}


def _fl_stacked():
    return {"w": torch.zeros(KF, D, 1), "b": torch.zeros(KF, 1)}


def _fl_engine():
    return ConsensusEngine(
        topology.ring(KF), codec="int8", plan="sparse",
        graph=topology.GraphProcess.dropout(0.3, seed=7),
        agents=topology.AgentProcess.bernoulli(0.7, seed=1), tau=2,
        staleness_decay=0.9)


def _target(thr):
    def target(sp):
        m = (sp["w"] - 1.0).square().mean()
        return m < thr, m
    return target


def _reads(monkeypatch):
    """Count the drivers' device→host reads (``scanloop.to_host``)."""
    count = [0]
    real = scanloop.to_host

    def counted(x):
        count[0] += 1
        return real(x)
    monkeypatch.setattr(scanloop, "to_host", counted)
    return count


def _run_fl(telemetry, chunk, thr, max_rounds=10):
    return federated.run_fl_until_scan(
        _fl_loss, _fl_stacked(), _fl_sample, _fl_engine(), 0.1,
        target_fn=_target(thr), max_rounds=max_rounds,
        generator=torch.Generator().manual_seed(0), chunk=chunk,
        return_state=True, telemetry=telemetry)


def _probe_threshold():
    _, _, hist, _ = _run_fl(None, 32, -1.0)
    return hist[4] * 0.999                    # first hit after round 5


def test_modes_are_bitwise_equal_and_sinks_see_live_rounds(monkeypatch):
    """FL driver with a hit mid-chunk (chunk 4): off, buffered and
    streaming give the same params, t_i, history and EF state; buffered
    and streaming fill the same buffer (live rounds and the discarded
    ones after the hit); sinks get the live rounds only, as they end
    (streaming) or at the chunk's end (buffered); buffered reads the
    device once per chunk as telemetry-off does, streaming once more per
    round computed."""
    thr = _probe_threshold()
    reads = _reads(monkeypatch)
    out, n_reads, tels = {}, {}, {}
    for mode in (None, "buffered", "streaming"):
        tel = None if mode is None else tl.Telemetry(
            mode=mode, sinks=(tl.MemorySink(),))
        reads[0] = 0
        out[mode] = _run_fl(tel, 4, thr)
        n_reads[mode], tels[mode] = reads[0], tel
    p, t_i, hist, st = out[None]
    assert 4 < t_i < 8                        # the hit is mid-chunk
    for mode in ("buffered", "streaming"):
        q, t_q, h_q, s_q = out[mode]
        assert (t_q, h_q) == (t_i, hist)
        for k in p:
            assert torch.equal(p[k], q[k]) and torch.equal(st[k], s_q[k])
    computed = 8                              # two chunks of 4
    assert n_reads[None] == n_reads["buffered"] == 2
    assert n_reads["streaming"] == 2 + computed
    buf = tels["buffered"].events(live_only=False)
    assert buf == tels["streaming"].events(live_only=False)
    assert len(buf) == computed
    live = tels["buffered"].events(driver="fl")
    assert [e["round"] for e in live] == list(range(t_i))
    assert live[-1]["reached"] and not any(e["reached"] for e in live[:-1])
    for e in buf[t_i:]:                       # discarded rounds: frozen rows
        assert not e["live"] and e["edges"] == 0 and e["joules"] == 0.0
        assert e["disagreement"] == 0.0 and not any(e["agent_sl"])
    for mode in ("buffered", "streaming"):
        assert tels[mode].sinks[0].events == live
    # the EF residuals and the async carry froze at the hit: a run cut at
    # max_rounds = t_i ends in the same state
    q, t_q, _, s_q = _run_fl(None, t_i, thr, max_rounds=t_i)
    assert t_q == t_i
    for k in p:
        assert torch.equal(p[k], q[k]) and torch.equal(st[k], s_q[k])


def test_scan_rounds_modes_bitwise_equal(monkeypatch):
    reads = _reads(monkeypatch)
    eng = _fl_engine()
    p = _t(_params(2, K=KF))
    ref, ref_st = eng.scan_rounds(p, rounds=4)
    bufs = []
    for mode in ("buffered", "streaming"):
        tel = tl.Telemetry(mode=mode, sinks=(tl.MemorySink(),))
        reads[0] = 0
        out, st = eng.scan_rounds(p, rounds=4, telemetry=tel)
        assert reads[0] == (1 if mode == "buffered" else 5)
        for k in p:
            assert torch.equal(out[k], ref[k]) and torch.equal(st[k], ref_st[k])
        ev = tel.events(driver="consensus")
        assert [e["round"] for e in ev] == [0, 1, 2, 3]
        assert tel.sinks[0].events == ev
        bufs.append(ev)
    assert bufs[0] == bufs[1]


def test_sleeping_agent_bills_zero_and_agents_sum_to_counts():
    """The (K,) agent_* rows attribute every delivered wire to its
    SENDER: they sum exactly to the aggregate counts and a sleeping agent
    bills exactly 0.0 J, on both plans, with the same rows on each."""
    rows = {}
    for plan in ("dense", "sparse"):
        eng = ConsensusEngine(
            topology.ring(KF), codec="int8:b64", plan=plan,
            graph=topology.GraphProcess.dropout(0.3, seed=7),
            agents=topology.AgentProcess.bernoulli(0.6, seed=1), tau=2,
            staleness_decay=0.9)
        rec = tl.RoundRecorder(eng)
        params = _t(_params(4, K=KF))
        rnd = eng.async_round(3, eng.init_async_state(device="cpu").age)
        row = rec.row(params, rnd.delivered, metric=0.0, reached=False,
                      live=True, active=rnd.act, age=rnd.age)
        ev = rec.event(3, row)
        rows[plan] = ev
        assert len(ev["agent_joules"]) == KF
        for cls in ("sl", "ul", "dl"):
            assert sum(ev[f"agent_{cls}"]) == ev[f"n_{cls}"], cls
        awake = rnd.act.tolist()
        assert not all(awake), "seed must put at least one agent to sleep"
        for k, up in enumerate(awake):
            if not up:
                assert ev["agent_joules"][k] == 0.0
                assert ev["agent_sl"][k] + ev["agent_ul"][k] \
                    + ev["agent_dl"][k] == 0
        assert ev["n_active"] == sum(awake)
        assert sum(ev["agent_joules"]) == pytest.approx(ev["joules"],
                                                        rel=1e-12)
    for f in EXACT:
        assert rows["dense"][f] == rows["sparse"][f], f


def test_static_per_agent_rows_match_link_classes():
    """Static rounds: per-sender counts are the topology's outgoing-link
    table, the same on both plans and as the JAX package's."""
    for topo, jt in ((topology.ring(K), jtopo.ring(K)),
                     (topology.hierarchical(2, 4), jtopo.hierarchical(2, 4))):
        lc = np.asarray(topo.link_class)
        for plan in ("dense", "sparse"):
            rec = tl.RoundRecorder(ConsensusEngine(topo, plan=plan))
            jrec = jtl.RoundRecorder(JEngine(jt, plan=PLANS[plan]))
            n = topo.K
            params = {"w": torch.ones(n, 3)}
            ev = rec.event(0, rec.row(params, None, metric=0.0,
                                      reached=False, live=True))
            jev = jrec.event(0, jrec.row({"w": jnp.ones((n, 3))}, None,
                                         metric=0.0, reached=False,
                                         live=True))
            for cls, code in (("sl", topology.SL), ("ul", topology.UL),
                              ("dl", topology.DL)):
                assert ev[f"agent_{cls}"] == (lc == code).sum(0).tolist()
            for f in EXACT:
                assert ev[f] == jev[f], (plan, f)


def test_frozen_row_and_live_row():
    rec = tl.RoundRecorder(ConsensusEngine(topology.ring(KF), plan="sparse"))
    row = rec.row(_t(_params(5, K=KF)), None, metric=2.5, reached=True,
                  live=True)
    frozen = rec.live_row(torch.tensor(False), row)
    zero = rec.frozen_row()
    assert set(frozen) == set(zero) == set(tl.ROW_FIELDS)
    for k in zero:
        assert torch.equal(frozen[k], zero[k]), k
        assert frozen[k].dtype == row[k].dtype, k
    kept = rec.live_row(torch.tensor(True), row)
    assert all(torch.equal(kept[k], row[k]) for k in row)
    assert rec.unpack(rec.pack([row, zero]).numpy())["metric"].tolist() == \
        [2.5, 0.0]


# -- schema, sinks, buffer, refusals, report ---------------------------------------


def test_jsonl_sink_schema_roundtrip(tmp_path):
    path = tmp_path / "events.jsonl"
    tel = tl.Telemetry(sinks=(tl.JsonlSink(path),))
    eng = ConsensusEngine(topology.ring(KF), codec="int8", plan="sparse",
                          graph=topology.GraphProcess.dropout(0.3, seed=7))
    eng.scan_rounds(_t(_params(6, K=KF)), rounds=4, telemetry=tel)
    tel.close()
    count, errors = tl.validate_jsonl(path)
    assert errors == [] and count == 4
    assert schema.main([str(path)]) == 0
    assert schema.main([]) == 2
    assert schema.COMMON_FIELDS == jtl.schema.COMMON_FIELDS
    assert schema.LEDGER_FIELDS == jtl.schema.LEDGER_FIELDS
    assert schema.MAML_FIELDS == jtl.schema.MAML_FIELDS
    # the JAX package's validator accepts the port's events too
    assert jtl.validate_jsonl(path) == (4, [])


def test_validate_event_rejects_bad_events(tmp_path):
    ok = {"type": "round", "driver": "maml", "round": 0, "live": True,
          "meta_loss": 0.5}
    assert tl.validate_event(ok) == []
    assert tl.validate_event({"type": "round"})
    assert any("meta_loss" in e
               for e in tl.validate_event(dict(ok, meta_loss="0.5")))
    assert tl.validate_event({"type": "round", "driver": "nope",
                              "round": 0, "live": True})
    path = tmp_path / "bad.jsonl"
    path.write_text('{"type": "round", "driver": "maml", "round": 0, '
                    '"live": true, "meta_loss": NaN}\n')
    _, errors = tl.validate_jsonl(path)
    assert errors
    assert schema.main([str(path)]) == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert schema.main([str(empty)]) == 1


def test_buffer_capacity_drops_oldest_and_mode_validated():
    buf = tl.MetricBuffer(capacity=3)
    buf.extend({"type": "round", "round": i, "live": True} for i in range(5))
    assert len(buf) == 3 and buf.dropped == 2
    assert [e["round"] for e in buf.rows()] == [2, 3, 4]
    with pytest.raises(ValueError, match="firehose"):
        tl.Telemetry(mode="firehose")
    tel = tl.Telemetry(capacity=2)
    tel.record_maml_rounds({"meta_loss": np.arange(3.0)}, 5)
    assert [e["round"] for e in tel.events()] == [6, 7]
    tel.reset()
    assert tel.events() == [] and tel.buffer.dropped == 0


def test_recorder_refusals_mirror_jax():
    mix = topology.ring(KF).mixing()
    with pytest.raises(ValueError) as ours:
        tl.RoundRecorder(ConsensusEngine(mix))
    with pytest.raises(ValueError) as theirs:
        jtl.RoundRecorder(JEngine(jtopo.ring(KF).mixing()))
    assert str(ours.value) == str(theirs.value)
    base, jbase = topology.ring(KF), jtopo.ring(KF)
    eff = np.where(base.adjacency, 2e6, 0.0)
    het = topology.Topology("het", base.adjacency, base.link_class,
                            edge_efficiency=eff)
    jhet = jtopo.Topology("het", jbase.adjacency, jbase.link_class,
                          edge_efficiency=eff)
    with pytest.raises(NotImplementedError) as ours:
        tl.RoundRecorder(ConsensusEngine(het))
    with pytest.raises(NotImplementedError) as theirs:
        jtl.RoundRecorder(JEngine(jhet))
    assert str(ours.value) == str(theirs.value)


def test_recorder_memoized_first_pricing_wins_and_report():
    from repro_torch.core import energy
    eng = ConsensusEngine(topology.ring(KF))
    tel = tl.Telemetry()
    fig4 = energy.paper_calibrated("fig4")
    rec = tel.recorder_for(eng, fig4)
    assert tel.recorder_for(eng) is rec and rec.energy_params == fig4
    eng.scan_rounds(_t(_params(7, K=KF)), rounds=2, telemetry=tel)
    rep = tel.report()
    assert rep["mode"] == "buffered" and rep["live_rounds"] == 2
    assert rep["joules"] == tel.joules(driver="consensus")
    assert set(rep["kernel_launches"]) == {
        "quant_consensus_pop", "consensus_update_pop", "rglru_scan",
        "flash_attention", "rglru_scan_backward", "flash_attention_backward"}
    assert set(rep["program_cache"]) >= {"hits", "misses", "inserts",
                                         "evictions", "trace_counts"}


def test_case_study_stream_reconciles_with_post_hoc_bill():
    """A tiny dynamic case study (paper-DQN cut to width 16, two layers,
    int8 wire, links fading, robots sleeping): the streamed per-task
    joules equal ``last_adapt_comm_joules`` exactly, each task has t_i
    live FL events, and t0, t_i, histories and params are bitwise those
    of a telemetry-off run."""
    from repro_torch.configs import get_arch
    from repro_torch.rl import casestudy
    cfg = dataclasses.replace(get_arch("paper-dqn"), d_model=16,
                              num_layers=2)
    common = dict(cfg=cfg, plan="sparse-pallas", device="cpu",
                  inner_steps=2, fl_local_steps=2, chunk=2, codec="int8",
                  dropout_p=0.3, dropout_seed=4, tau=1,
                  availability=topology.AgentProcess.bernoulli(0.75, seed=1),
                  staleness_decay=0.9)
    runs = {}
    for mode in (None, "streaming"):
        tel = None if mode is None else tl.Telemetry(
            mode=mode, sinks=(tl.MemorySink(),))
        cs = casestudy.CaseStudy(telemetry=tel, **common)
        res = cs.run(torch.Generator().manual_seed(0), 2, max_rounds=3)
        runs[mode] = (cs, res, tel)
    cs0, res0, _ = runs[None]
    cs, res, tel = runs["streaming"]
    assert res.rounds_per_task == res0.rounds_per_task
    assert res.meta_history == res0.meta_history
    assert res.fl_histories == res0.fl_histories
    assert res.E_total == res0.E_total
    for tid, t_i in enumerate(res.rounds_per_task):
        for k in cs.fl_params[tid]:
            assert torch.equal(cs.fl_params[tid][k], cs0.fl_params[tid][k])
        assert tel.joules(task_id=tid) == res.fl_comm_joules_measured[tid]
        ev = [e for e in tel.events(driver="fl") if e["task_id"] == tid]
        assert len(ev) == t_i
        assert [e["metric"] for e in ev] == res.fl_histories[tid]
        assert not any(e["reached"] for e in ev[:-1])
        assert ev[-1]["reached"] or t_i == 3
    maml = tel.events(driver="maml")
    assert [e["meta_loss"] for e in maml] == res.meta_history
    assert all(e["meta_grad_norm"] > 0 for e in maml)
    assert tel.sinks[0].events == tel.events(driver="maml") + \
        tel.events(driver="fl")
