"""The port's sharded and distributed consensus plans against the JAX
package's and against the port's own sparse plan, on the CPU.

* ``permutation_schedule`` equals the reference's, pairs and σ.
* With round-to-nearest the sharded plan equals the sparse plan bit for
  bit at any block count that divides K: static, fading and async rounds,
  codecs None, int8, int4, int8:b64 and bf16 (every block's rows go
  through the same kernel arithmetic on the same lanes).
* Both plans against the reference's emulated steps at K = 256, and the
  distributed plan against the sparse plan: the distributed plan sums its
  slots in schedule order, not in ascending lane order, so these are held
  to the sparse-vs-dense gate, 1e-5 plus 4 f32 ulps of the largest value
  (round to nearest and zero EF state put the same int lanes on the wire
  in both packages, so one int8 round is held to the same gate).
* The population mean under doubly stochastic σ, plan selection with and
  without a mesh, the schedule-bound refusal, telemetry rows (``==`` the
  reference's counts and joules).
* Real process groups: 4 gloo ranks on the sharded plan and 8 on the
  distributed plan, each rank's 4 masked rounds of ``scan_rounds`` with a
  generator and buffered telemetry against the one-process rounds: params
  and codec state, the generator's final state and every row's exact
  fields ``==``, disagreement within its tolerance
  (``repro_torch.launch.multichip``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtl  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch import telemetry as tl  # noqa: E402
from repro_torch.core import consensus, topology  # noqa: E402
from repro_torch.core import engine as engine_lib  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, multichip  # noqa: E402

K = 16
CODECS = [None, "int8", "int4", "int8:b64", "bf16"]


def _params(K=K, seed=0, n=40):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, n)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def _t(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _process(mod, name):
    if name == "dropout":
        return dict(graph=mod.GraphProcess.dropout(0.3, seed=1))
    if name == "async":
        return dict(agents=mod.AgentProcess.bernoulli(0.7, seed=2), tau=2,
                    staleness_decay=0.9)
    return {}


def _gate(x):
    return 1e-5 + 4 * np.finfo(np.float32).eps * float(np.abs(x).max())


@pytest.mark.parametrize("gamma", [1.0, 0.5])
@pytest.mark.parametrize("name", ["ring", "small_world", "cluster", "star"])
def test_permutation_schedule_matches_reference(name, gamma):
    kw = {"k": 4, "seed": 1} if name == "small_world" else {}
    mix = (topology.make(name, 24, **kw).mixing() if name != "small_world"
           else topology.small_world(24, **kw).mixing())
    ours = consensus.permutation_schedule(mix, gamma)
    theirs = jcons.permutation_schedule(mix, gamma)
    assert len(ours) == len(theirs)
    for (p, s), (jp, js) in zip(ours, theirs):
        assert p == jp
        np.testing.assert_array_equal(s, np.asarray(js))
    srcs = consensus.schedule_sources(ours, 24)
    for m, (pairs, _) in enumerate(ours):
        assert sorted(s for s, _ in pairs) == list(range(24))
        assert all(srcs[m, t] == s for s, t in pairs)


@pytest.mark.parametrize("process", ["static", "dropout", "async"])
@pytest.mark.parametrize("codec", CODECS)
def test_sharded_equals_sparse_bit_for_bit(codec, process):
    topo = topology.small_world(K, k=4, seed=1)
    x = _t(_params())
    sparse = ConsensusEngine(topo, codec=codec, plan="sparse",
                             **_process(topology, process))
    want, wst = sparse.scan_rounds(x, rounds=3)
    for nb in (1, 2, 4):
        eng = ConsensusEngine(topo, codec=codec, plan="sharded",
                              num_blocks=nb, **_process(topology, process))
        assert (eng.plan.kind, eng.plan.num_blocks) == ("sharded", nb)
        got, st = eng.scan_rounds(x, rounds=3)
        for k in x:
            assert torch.equal(got[k], want[k]), (nb, k)
            if st is not None:
                assert torch.equal(st[k], wst[k]), (nb, k)


@pytest.mark.parametrize("process", ["static", "dropout", "async"])
@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
def test_distributed_agrees_with_sparse(codec, process):
    topo = topology.small_world(K, k=4, seed=1)
    p = _params(seed=2)
    x = _t(p)
    out = {}
    for plan in ("sparse", "distributed"):
        eng = ConsensusEngine(topo, codec=codec, plan=plan,
                              **_process(topology, process))
        if plan == "distributed":
            assert eng.plan.kind == "distributed"
        out[plan] = eng.step(x, eng.init_state(x), t=0) if (
            eng.agents is None) else eng.async_step(
            x, None, t=0, state=eng.init_async_state(device="cpu"))[:2]
    for k in x:
        for a, b in zip(out["distributed"], out["sparse"]):
            if a is None:
                continue
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                       atol=_gate(p[k]), err_msg=k)


@pytest.mark.parametrize("process", ["static", "dropout"])
@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("plan", ["sharded", "distributed"])
def test_plans_match_jax_engine_at_256(plan, codec, process):
    K2 = 256
    topo = topology.small_world(K2, k=4, seed=1)
    jt = jtopo.small_world(K2, k=4, seed=1)
    kw = {"num_blocks": 4} if plan == "sharded" else {}
    eng = ConsensusEngine(topo, codec=codec, plan=plan,
                          **_process(topology, process), **kw)
    jeng = JEngine(jt, codec=codec, plan=plan, **_process(jtopo, process),
                   **kw)
    p = _params(K2, seed=3, n=24)
    x, jx = _t(p), _j(p)
    out, st = eng.step(x, eng.init_state(x), t=3)
    jout, jst = jeng.step(jx, jeng.init_state(jx), t=3)
    assert (st is None) == (jst is None) == (codec is None)
    for k in p:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=_gate(p[k]), err_msg=k)
        if st is not None:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=0, atol=_gate(p[k]), err_msg=k)


@pytest.mark.parametrize("plan,kw", [("sharded", {"num_blocks": 4}),
                                     ("distributed", {})])
def test_mesh_plans_keep_population_mean(plan, kw):
    """CHOCO recentring: under a doubly stochastic σ the population mean
    survives the int8 wire (up to f32 summation)."""
    mix = topology.ring(16).mixing(kind="metropolis")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 33))
                         .astype(np.float32))
    eng = ConsensusEngine(mix, codec="int8", plan=plan, **kw)
    out, _ = eng.step({"w": x}, eng.init_state({"w": x}))
    torch.testing.assert_close(out["w"].mean(0), x.mean(0), rtol=0,
                               atol=1e-5)


def test_plan_selection_without_a_mesh(monkeypatch):
    """``auto`` follows the density rule (with the port's floor); explicit
    sharded/distributed plans run the whole population in one process."""
    assert ConsensusEngine(topology.ring(256)).plan.kind == "sparse"
    assert ConsensusEngine(topology.star(256)).plan.kind == "dense"
    assert ConsensusEngine(topology.star(256), codec="int8").plan.kind \
        == "sparse"
    monkeypatch.setattr(jcons, "SPARSE_GATHER_FLOOR",
                        consensus.SPARSE_GATHER_FLOOR)
    for fam in ("ring", "star", "cluster"):
        got = ConsensusEngine(topology.make(fam, 64), codec="int8").plan.kind
        want = JEngine(jtopo.make(fam, 64), codec="int8").plan.kind
        assert engine_lib.PLAN_ALIASES.get(want, want) == got
    eng = ConsensusEngine(topology.ring(12), plan="sharded")
    assert (eng.plan.num_blocks, eng.local_rows, eng.mesh_positions) == \
        (1, None, 1)
    assert ConsensusEngine(topology.ring(12), plan="distributed").plan.kind \
        == "distributed"
    with pytest.raises(ValueError, match="divide"):
        ConsensusEngine(topology.ring(12), plan="sharded",
                        num_blocks=5).step({"w": torch.ones(12, 3)})


def test_plan_selection_with_a_mesh(tmp_path):
    """A one-position gloo mesh: ``auto`` honours it (sharded, or
    distributed with one agent per position), and a block count that
    does not divide K falls back to the largest one that does."""
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"))
    try:
        mesh = mesh_lib.make_agent_mesh()
        eng = ConsensusEngine(topology.ring(8), mesh=mesh)
        assert (eng.plan.kind, eng.plan.num_blocks) == ("sharded", 1)
        assert eng.local_rows == slice(0, 8)
        one = ConsensusEngine(np.zeros((1, 1), np.float32), mesh=mesh)
        assert one.plan.kind == "distributed"
        eng12 = ConsensusEngine(topology.ring(12), mesh=mesh, num_blocks=8)
        assert (eng12.plan.kind, eng12.plan.num_blocks) == ("sharded", 6)
        out, _ = eng12.step({"w": torch.ones(12, 5)})
        assert out["w"].shape == (12, 5)
        # a mesh without the agent axis leaves auto to the density rule
        other = ConsensusEngine(topology.ring(256), mesh=mesh,
                                axis_name="model")
        assert other.plan.kind == "sparse"
        # the mesh spans the group: any other position count is refused
        assert mesh_lib.make_agent_mesh(positions=1).size() == 1
        for bad in (2, -1):
            with pytest.raises(ValueError, match="world size 1"):
                mesh_lib.make_agent_mesh(positions=bad)
    finally:
        mesh_lib.destroy_local_group()
    with pytest.raises(RuntimeError, match="init_local_group"):
        mesh_lib.make_agent_mesh()


def test_schedule_bound_refusal():
    bound = engine_lib.DISTRIBUTED_SCHEDULE_BOUND
    assert bound == 64
    for kw in (dict(graph=topology.GraphProcess.dropout(0.3)),
               dict(agents=topology.AgentProcess.always_on())):
        with pytest.raises(ValueError, match="schedule slots") as ei:
            ConsensusEngine(topology.full(bound + 6), plan="distributed",
                            **kw)
        assert str(bound) in str(ei.value) and "sparser" in str(ei.value)
    # under the bound at the same K on a sparse graph, and a static
    # engine builds its schedule lazily whatever its size
    ConsensusEngine(topology.ring(bound + 6), plan="distributed",
                    graph=topology.GraphProcess.dropout(0.3))
    ConsensusEngine(topology.full(bound + 6), plan="distributed")


#: fields that depend only on the draws: equal between the packages
EXACT = ("round", "n_sl", "n_ul", "n_dl", "edges", "n_active", "max_age",
         "agent_sl", "agent_ul", "agent_dl", "wire_bits", "joules",
         "agent_joules")


@pytest.mark.parametrize("process", ["static", "dropout", "async"])
@pytest.mark.parametrize("plan", ["sharded", "distributed"])
def test_telemetry_rows_match_jax(plan, process):
    topo = topology.small_world(K, k=4, seed=1)
    jt = jtopo.small_world(K, k=4, seed=1)
    kw = {"num_blocks": 4} if plan == "sharded" else {}
    eng = ConsensusEngine(topo, codec="int8", plan=plan,
                          **_process(topology, process), **kw)
    jeng = JEngine(jt, codec="int8", plan=plan, **_process(jtopo, process),
                   **kw)
    p = _params(seed=4)
    tel, jtel = tl.Telemetry(), jtl.Telemetry()
    eng.scan_rounds(_t(p), rounds=3, t0=1, telemetry=tel)
    jeng.scan_rounds(_j(p), rounds=3, t0=1, telemetry=jtel)
    ev, jev = tel.events(), jtel.events()
    assert len(ev) == len(jev) == 3
    for e, je in zip(ev, jev):
        assert e["plan"] == plan
        for f in EXACT:
            assert e[f] == je[f], f
    assert tel.joules(driver="consensus") == jtel.joules(driver="consensus")
    # the rows bill what the round mixed with: the same counts as the
    # sparse plan's lanes
    sp_tel = tl.Telemetry()
    ConsensusEngine(topo, codec="int8", plan="sparse",
                    **_process(topology, process)).scan_rounds(
        _t(p), rounds=3, t0=1, telemetry=sp_tel)
    for e, se in zip(ev, sp_tel.events()):
        assert all(e[f] == se[f] for f in EXACT)


def test_mesh_engine_refusals():
    with pytest.raises(TypeError, match="DeviceMesh"):
        ConsensusEngine(topology.ring(8), mesh="agents")
    x = {"w": torch.ones(16, 3)}
    with pytest.raises(ValueError, match="rows per process"):
        consensus.distributed_consensus_step(
            {"w": torch.ones(15, 3)}, topology.ring(16).mixing())
    with pytest.raises(ValueError, match="sig_override"):
        consensus.distributed_consensus_step(
            x, topology.ring(16).mixing(), sig_override=torch.zeros(16, 9))
    with pytest.raises(ValueError, match="codec_state"):
        consensus.sharded_consensus_step(
            x, topology.ring(16).mixing(), num_blocks=2, codec="int8",
            codec_state={"v": torch.zeros(16, 3)})


def test_gloo_group_of_4_sharded_matches_emulation():
    rows = multichip.run_parity(4, [c for c in multichip.parity_cases(4)
                                    if c[1] == "sharded"])
    assert len(rows) == 4 * 2
    assert all(r["bit_equal"] and r["positions"] == 4 for r in rows)
    assert all(r["rows_equal"] and r["n_rows"] == multichip.PARITY_ROUNDS
               and r["disagreement_of_tol"] <= 1.0 for r in rows)
    assert sorted(tuple(r["rows"]) for r in rows if r["codec"] is None) == \
        [(0, 4), (4, 8), (8, 12), (12, 16)]


def test_gloo_group_of_8_distributed_matches_emulation():
    rows = multichip.run_parity(8, [c for c in multichip.parity_cases(8)
                                    if c[1] == "distributed"])
    assert len(rows) == 8 * 2
    assert all(r["ok"] and r["positions"] == 8 for r in rows)
    assert all(r["max_abs_err"] <= r["tolerance"] for r in rows)
    assert all(r["rows_equal"] and r["n_rows"] == multichip.PARITY_ROUNDS
               and r["disagreement_of_tol"] <= 1.0 for r in rows)
