"""The paper's stage 2 across a real process group: the port's FL drivers,
``scan_rounds`` and Eq.-(11) telemetry on an engine whose agents are
spread over the ranks of a gloo group, against the same engine built
without a mesh and, through it, against the JAX package.

Two spawns (``repro_torch.launch.multichip.run_mesh_checks``), each
running all of its cases: 4 ranks on the sharded plan (K = 16,
small_world(k=4), a block of 4 agents a rank) and 8 ranks on the
distributed plan (K = 8, one agent a rank); codecs None and int8 with a
generator (stochastic rounding), on static links, fading links (p = 0.3)
and sleeping agents (awake with p = 0.7, τ = 2, λ = 0.9); and int8 on
fading links with ``eval_every=2``.

* ``run_fl_until_scan`` (chunk 8) and ``run_fl_until`` on a regression
  pull toward seeded targets, the hit mid-chunk (t_i = 4): on every rank
  the params and codec state (its rows), t_i, history, the generator's
  final state and the telemetry rows' exact fields ``==`` the one-process
  run, the disagreement within ``telemetry.buffer.disagreement_tolerance``;
  each rank's collectives recorded: one population gather per evaluated
  round computed (none on the rounds ``eval_every`` skips), C3 clean, and
  only rank 0 emitting to the sinks; the exact fields also ``==`` the JAX package's rows of the emulated plan
  over as many rounds.
* 4 rounds of ``scan_rounds`` with a generator and buffered telemetry
  (the JAX package's ``parity_mesh_vs_emulation``), and on async engines
  the ``AsyncState`` of 4 ``async_step`` rounds, ``==`` on every rank.
* The stochastic-rounding repair: a rank draws the one-process run's
  rounding noise for its rows and leaves the generator in the one-process
  state (``consensus._emulation_noise``).
* In process: one-position meshes (what a single card can run), the noise
  helper against the per-block draws, the driver's refusal of a batch
  that is not the whole population, and a meshed run's JSONL log (only
  the agent axis's rank 0 emits to the sinks: checked on every rank of
  the spawns). The C3 cases of the meshed drivers are in
  ``tests/test_torch_costmodel.py``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtl  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch import telemetry as tl  # noqa: E402
from repro_torch.comms import codecs  # noqa: E402
from repro_torch.core import consensus, federated, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, multichip  # noqa: E402

PROCESSES = ("static", "fading", "async")
CODECS = (None, "int8")
#: plan -> (ranks, K)
GROUPS = {"sharded": (4, 16), "distributed": (8, 8)}


def _cases(plan):
    """Every codec x process, each round evaluated; and int8 on fading
    links evaluated every 2nd round."""
    ranks, K = GROUPS[plan]
    topo = topology.small_world(K, k=4, seed=1)
    return [(topo, plan, c, p) for c in CODECS for p in PROCESSES] + [
        (topo, plan, "int8", "fading", 2)]


_RESULTS = {}


def _checks(plan):
    """The plan's one spawn (parity and FL cases), run once per module."""
    if plan not in _RESULTS:
        ranks, _ = GROUPS[plan]
        cases = _cases(plan)
        parity = [c for c in cases if len(c) == 4]   # no eval_every there
        _RESULTS[plan] = multichip.run_mesh_checks(ranks, parity, cases,
                                                   timeout_s=240.0)
    return _RESULTS[plan]


@pytest.mark.parametrize("plan", list(GROUPS))
def test_fl_drivers_on_a_mesh_match_one_process(plan):
    ranks, K = GROUPS[plan]
    rows = _checks(plan)["fl"]
    assert len(rows) == ranks * (len(CODECS) * len(PROCESSES) + 1) * 2
    assert {(r["codec"], r["process"]) for r in rows} == {
        (c, p) for c in CODECS for p in PROCESSES}
    assert {r["eval_every"] for r in rows} == {1, 2}
    for r in rows:
        assert r["ok"], r
        assert r["history_equal"] and r["generator_equal"], r
        assert r["bit_equal"], r                 # both plans, on the CPU
        assert 1 < r["rounds"] < multichip.FL["chunk"], r   # mid-chunk
        assert r["rows_equal"] and r["n_rows"] == r["rounds"], r
        assert r["disagreement_of_tol"] <= 1.0, r
        # one population gather per round computed on the eval_every grid,
        # none on the rounds it skips; C3 books exactly those
        computed = multichip.rounds_computed(r["rounds"], r["chunk"],
                                             multichip.FL["max_rounds"])
        assert r["gathers"] == r["gathers_expected"] == \
            computed // r["eval_every"], r
        assert r["c3"] == [], r
        # one log: only the agent axis's rank 0 emits to the sinks
        assert r["emitted"] == (r["n_rows"] if r["rank"] == 0 else 0), r
    # chunk 8 == chunk 1 on the one-process side (and so on every rank)
    for runs in _checks(plan)["alone"].values():
        a, b = runs[multichip.FL["chunk"]], runs[1]
        assert (a["rounds"], a["history"]) == (b["rounds"], b["history"])
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
        assert a["events"] == b["events"]


def _jax_process(process):
    if process == "fading":
        return dict(graph=jtopo.GraphProcess.dropout(
            multichip.DROPOUT_P, multichip.DROPOUT_SEED))
    if process == "async":
        return dict(agents=jtopo.AgentProcess.bernoulli(0.7, seed=2), tau=2,
                    staleness_decay=0.9)
    return {}


@pytest.mark.parametrize("plan", list(GROUPS))
def test_fl_rows_match_jax(plan):
    """Every case's rows (the one-process rows, which every rank's equal)
    against the JAX package's emulated plan over as many rounds: one
    ``scan_rounds`` call a case; the exact fields depend only on the
    draws, so they are ``==``."""
    ranks, K = GROUPS[plan]
    checks = _checks(plan)
    jt = jtopo.small_world(K, k=4, seed=1)
    kw = {"num_blocks": ranks} if plan == "sharded" else {}
    for i, (_topo, _plan, codec, process, _every, _thr) in enumerate(
            checks["cases"]):
        ev = checks["alone"][i][multichip.FL["chunk"]]["events"]
        jeng = JEngine(jt, codec=codec, plan=plan, **_jax_process(process),
                       **kw)
        pop = multichip.population(K, multichip.FL["n"], multichip.FL["seed"])
        jtel = jtl.Telemetry()
        jeng.scan_rounds({k: jnp.asarray(v) for k, v in pop.items()},
                         rounds=len(ev), telemetry=jtel)
        jev = jtel.events()
        assert len(jev) == len(ev) > 1
        for e, je in zip(ev, jev):
            assert e["driver"] == "fl" and e["plan"] == plan
            for f in multichip.EXACT:
                assert e[f] == je[f], (codec, process, f)


@pytest.mark.parametrize("plan", list(GROUPS))
def test_scan_rounds_with_telemetry_on_a_mesh(plan):
    """4 rounds of ``scan_rounds`` with a generator and buffered telemetry
    on every rank ``==`` the one-process rounds (params, codec state, the
    generator, the rows' exact fields), the async carry of 4
    ``async_step`` rounds too; telemetry is no longer refused."""
    ranks, K = GROUPS[plan]
    rows = _checks(plan)["parity"]
    assert len(rows) == ranks * len(CODECS) * len(PROCESSES)
    for r in rows:
        assert r["ok"] and r["bit_equal"], r
        assert r["rows_equal"] and r["n_rows"] == multichip.PARITY_ROUNDS, r
        assert r["disagreement_of_tol"] <= 1.0, r
        assert r["generator_equal"] and r["async_equal"], r
        assert r["rows"] == ([r["rank"] * (K // ranks),
                              (r["rank"] + 1) * (K // ranks)])


@pytest.mark.parametrize("plan", list(GROUPS))
def test_stochastic_rounding_on_a_mesh_draws_the_emulations_noise(plan):
    """The repair: with a generator, rank r's int8 wire carries the noise
    the one-process run draws for rank r's rows (rank 0 alone would agree
    if each rank drew from the start of the stream), and every rank's
    generator ends where the one-process run's does, so the next
    ``sample_batches`` draws the same batches."""
    ranks, _ = GROUPS[plan]
    checks = _checks(plan)
    int8 = [r for r in checks["parity"] + checks["fl"] if r["codec"] == "int8"]
    assert {r["rank"] for r in int8} == set(range(ranks))
    assert all(r["bit_equal"] and r["generator_equal"] for r in int8)


@pytest.mark.parametrize("spec", ["int8", "int4", "int8:b64", "int4:b5+ef",
                                  "bf16", "topk:0.2", None])
@pytest.mark.parametrize("draws,rows", [(4, 3), (1, 12)])
def test_emulation_noise_is_the_per_block_draws(spec, draws, rows):
    """``_emulation_noise`` keeps a position's rows of the draws the
    one-process run makes, group by group in their own shapes, and ends
    the generator in that run's state; encoding with it equals encoding
    the rows with the generator itself."""
    codec = codecs.resolve_codec(spec)
    n, K = 37, draws * rows
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (K, n)).astype(np.float32))
    ref = torch.Generator().manual_seed(3)
    want = [codec.encode_leaf(x[d * rows:(d + 1) * rows], ref)
            if codec is not None else None for d in range(draws)]
    for start, stop in ((0, rows), (K - rows, K), (K // 2, K // 2 + 1)):
        gen = torch.Generator().manual_seed(3)
        u = consensus._emulation_noise(codec, gen, n, draws, rows,
                                       slice(start, stop), "cpu")
        if codec is None or codec.noise_shape(1, n) is None:
            assert u is None
            continue
        assert torch.equal(gen.get_state(), ref.get_state())
        d = start // rows
        assert stop <= (d + 1) * rows
        got = codec.encode_leaf(x[start:stop], None, u)
        lo = start - d * rows
        for key, v in want[d].items():
            assert torch.equal(got[key], v[lo:lo + stop - start]), key


def _one_position_mesh(tmp_path):
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"))
    return mesh_lib.make_agent_mesh()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("process", PROCESSES)
def test_one_position_mesh_fl_equals_one_process(tmp_path, process, codec):
    """The mesh code on a 1-position mesh (what one card runs, world size
    1): ``run_fl_until_scan`` with buffered telemetry gives the run
    without a mesh bit for bit (disagreement within its tolerance)."""
    topo = topology.small_world(16, k=4, seed=1)
    try:
        mesh = _one_position_mesh(tmp_path)
        on_mesh, alone = multichip.mesh_pair(topo, "sharded", codec, mesh,
                                             process)
        assert on_mesh.local_rows == slice(0, 16)
        pop = multichip.population(16, multichip.FL["n"],
                                   multichip.FL["seed"])
        x = {k: torch.from_numpy(v) for k, v in pop.items()}
        thr = multichip.fl_threshold(alone, x, device="cpu")
        got = multichip.fl_run(on_mesh, x, thr, chunk=8, device="cpu",
                               record=True)
        want = multichip.fl_run(alone, x, thr, chunk=8, device="cpu")
    finally:
        mesh_lib.destroy_local_group()
    r = multichip.fl_compare(got, want, slice(0, 16), "sharded")
    assert r["ok"] and r["bit_equal"] and r["rows_equal"], r
    assert r["rounds"] == 4 and r["gathers"] == 8 and r["c3"] == []
    assert r["emitted"] == r["n_rows"] == 4


def test_meshed_round_takes_the_whole_populations_batches(tmp_path):
    topo = topology.ring(8)
    try:
        eng = ConsensusEngine(topo, plan="sharded",
                              mesh=_one_position_mesh(tmp_path))
        p = {"w": torch.zeros(8, 3)}
        with pytest.raises(ValueError, match="whole population"):
            federated.decentralized_fl_round(
                lambda q, b: ((q["w"] - b["w"]) ** 2).sum(), p,
                {"w": torch.ones(7, 1, 3)}, eng, 0.1)
        out = federated.decentralized_fl_round(
            lambda q, b: ((q["w"] - b["w"]) ** 2).sum(), p,
            {"w": torch.ones(8, 1, 3)}, eng, 0.1)
        assert out["w"].shape == (8, 3)
    finally:
        mesh_lib.destroy_local_group()


def test_jsonl_log_of_a_meshed_run(tmp_path):
    """A meshed run's JSONL log is written by the agent axis's rank 0 (the
    multi-rank spawns above check that the other ranks emit nothing) and
    holds the run's events; the sink itself knows nothing of the group."""
    topo = topology.small_world(16, k=4, seed=1)
    x = {k: torch.from_numpy(v) for k, v in multichip.population(
        16, multichip.FL["n"], multichip.FL["seed"]).items()}
    sink = tl.JsonlSink(tmp_path / "fl.jsonl")
    tel = tl.Telemetry(sinks=(sink,))
    try:
        on_mesh, _ = multichip.mesh_pair(topo, "sharded", "int8",
                                         _one_position_mesh(tmp_path))
        federated.run_fl_until_scan(
            lambda p, b: sum(((p[k] - b[k]) ** 2).sum() for k in p), x,
            lambda g, t: {k: v.unsqueeze(1) for k, v in x.items()}, on_mesh,
            0.1, target_fn=lambda s: (False, s["w"].mean()), max_rounds=3,
            generator=torch.Generator().manual_seed(0), chunk=2,
            telemetry=tel)
    finally:
        tel.close()
        mesh_lib.destroy_local_group()
    lines = (tmp_path / "fl.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == json.loads(
        json.dumps(tel.events())) and len(lines) == 3
