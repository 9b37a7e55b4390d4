"""The port's ConsensusEngine against the JAX package's ``engine.step`` on
the same agent-stacked params (numpy, from a seed): K = 64,
{ring, cluster, small-world} × {None, int8, int8:b64, bf16} ×
{dense, sparse}, round to nearest (no key / generator) and zero EF state,
so both packages put the same int lanes on the wire."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import consensus as jcons  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch.core import consensus, energy, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine, ExecutionPlan  # noqa: E402

K = 64


def _topos(fam):
    if fam == "ring":
        return topology.ring(K), jtopo.ring(K)
    if fam == "cluster":
        return topology.make("cluster", K), jtopo.make("cluster", K)
    return (topology.small_world(K, k=4, seed=1),
            jtopo.small_world(K, k=4, seed=1))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 40)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def _atol(x):
    # round to nearest and zero EF state put the same lanes on the wire in
    # both packages (tests/test_torch_codecs.py holds them with ==), so the
    # outputs differ only by summation order: 1e-5 plus a few f32 ulps of
    # the largest value. A wrong CHOCO recentring moves them by a fraction
    # of a quantizer step, orders of magnitude more.
    return 1e-5 + 4 * np.finfo(np.float32).eps * float(np.abs(x).max())


@pytest.mark.parametrize("plan", ["dense", "sparse"])
@pytest.mark.parametrize("codec", [None, "int8", "int8:b64", "bf16"])
@pytest.mark.parametrize("fam", ["ring", "cluster", "small_world"])
def test_step_matches_jax_engine(fam, codec, plan):
    topo, jtopo_ = _topos(fam)
    p = _params()
    eng = ConsensusEngine(topo, codec=codec, plan=plan)
    jeng = JEngine(jtopo_, codec=codec,
                   plan={"dense": "dense-xla", "sparse": "sparse-pallas"}[plan])
    assert eng.plan.kind == plan
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out, st = eng.step(tp, eng.init_state(tp))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jout, jst = jeng.step(jp, jeng.init_state(jp))
    assert (st is None) == (jst is None) == (codec is None)
    for k in p:
        atol = _atol(p[k])
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=atol, err_msg=k)
        if st is not None:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=0, atol=atol, err_msg=k)
    assert eng.round_comm_joules(energy.paper_calibrated("fig3")) == \
        jeng.round_comm_joules(jen.paper_calibrated("fig3"))


@pytest.mark.parametrize("codec", ["int8", "int4", "int8:b64"])
def test_sparse_plan_keeps_population_mean(codec):
    """CHOCO recentring: under a doubly-stochastic σ the population mean
    survives compression (up to f32 summation)."""
    mix = topology.ring(16).mixing(kind="metropolis")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 33))
                         .astype(np.float32))
    eng = ConsensusEngine(mix, codec=codec, plan="sparse")
    out, _ = eng.step({"w": x})
    torch.testing.assert_close(out["w"].mean(0), x.mean(0), rtol=0, atol=1e-5)


def test_sparse_plan_agrees_with_dense_plan():
    topo = topology.small_world(K, k=4, seed=1)
    tp = {k: torch.from_numpy(v) for k, v in _params(2).items()}
    for codec in (None, "int8", "topk:0.1"):
        d, _ = ConsensusEngine(topo, codec=codec, plan="dense").step(tp)
        s, _ = ConsensusEngine(topo, codec=codec, plan="sparse").step(tp)
        for k in tp:
            torch.testing.assert_close(s[k], d[k], rtol=0, atol=1e-5)


def test_plan_selection_and_refusals(monkeypatch):
    assert ConsensusEngine(topology.ring(256), codec="int8").plan.kind == "sparse"
    assert ConsensusEngine(topology.ring(256)).plan.kind == "sparse"
    # the port's floor (24, measured on the card; PERF.md) keeps
    # the case study's 2-robot clusters dense and puts a 12-ring sparse
    assert ConsensusEngine(topology.clusters(1, 2)).plan.kind == "dense"
    assert ConsensusEngine(topology.ring(12)).plan.kind == "sparse"
    assert ConsensusEngine(topology.clusters(6, 2)).plan.kind == "dense"
    assert ConsensusEngine(topology.full(256)).plan.kind == "dense"
    assert ConsensusEngine(topology.ring(8), plan="sparse-pallas").plan.kind \
        == "sparse"
    assert ConsensusEngine(topology.ring(8), plan="dense-xla").plan.kind \
        == "dense"
    # the reference's rule with the port's floor picks what the port picks
    monkeypatch.setattr(jcons, "SPARSE_GATHER_FLOOR",
                        consensus.SPARSE_GATHER_FLOOR)
    for fam in ("ring", "cluster", "small_world"):
        topo, jt = _topos(fam)
        for codec in (None, "int8", "bf16"):
            want = JEngine(jt, codec=codec).plan.kind
            got = ConsensusEngine(topo, codec=codec).plan.kind
            assert {"dense": "dense-xla", "sparse": "sparse-pallas"}[got] == want
    with pytest.raises(ValueError, match="sparse"):
        ExecutionPlan("sparce", "typo")
    # a mesh is a DeviceMesh (tests/test_torch_mesh.py drives real ones)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ConsensusEngine(topology.ring(8), mesh=object())
    # time-varying graphs and availability are ported (tests/test_torch_
    # dynamic.py); what is left is the reference's own validation
    with pytest.raises(TypeError, match="AgentProcess"):
        ConsensusEngine(topology.ring(8), agents=object())
    with pytest.raises(ValueError, match="only applies to async engines"):
        ConsensusEngine(topology.ring(8), tau=3)
    assert ConsensusEngine(
        topology.ring(8),
        graph=topology.GraphProcess.dropout(0.1)).graph.kind == "dropout"
    with pytest.raises(ValueError, match="Topology"):
        ConsensusEngine(topology.ring(8).mixing()).round_comm_joules(
            energy.PAPER_TABLE_I)


def test_consensus_step_and_error_match():
    topo, jt = _topos("ring")
    p = _params(3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for impl, jimpl in (("dense", "xla"), ("sparse", "sparse"),
                        ("auto", "auto")):
        out = consensus.consensus_step(tp, topo, impl=impl)
        want = jcons.consensus_step(jp, jt, impl=jimpl)
        for k in p:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(consensus.consensus_error(tp)),
                               float(jcons.consensus_error(jp)), rtol=1e-6)
    with pytest.raises(ValueError, match="codec"):
        consensus.consensus_step(tp, topo, gamma=0.5)
