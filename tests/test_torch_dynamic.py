"""The port's time-varying and asynchronous consensus against the JAX
package's ``ConsensusEngine``, called at the step level on the same
numpy-made params: per-round lane survival, availability rounds, lockstep
rounds on fading links (``step(t=)``), async rounds (``async_step``) and
``scan_rounds``, on the dense and sparse plans, for codecs {None, int8,
bf16}; within the port, the always-on reduction to lockstep and the
no-op of a round in which every agent sleeps; the validation errors; and
the case study's post-hoc Eq.-(11) replay against the JAX package's.

Tolerances. Masks, activity, delivered wires and ages are integer results
and must be equal. The staleness weights ``λ^age`` may differ by one f32
ulp (XLA's and PyTorch's ``pow``). Params and EF residuals are held to
1e-5 plus 4 f32 ulps of the leaf's largest value (tests/test_torch_
engine.py's gate): from the same inputs both packages put the same int
lanes on the wire, and the outputs differ only by summation order. Each
round of a multi-round comparison starts both packages from the same
state, since one lane rounding the other way in a later round would move
a value by a quantizer step."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import energy as jen  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import AsyncState as JAsyncState  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro.core.protocol import ProtocolResult as JResult  # noqa: E402
from repro import comms as jcomms  # noqa: E402
from repro_torch.core import energy, topology  # noqa: E402
from repro_torch.core.engine import (AsyncState, ConsensusEngine,  # noqa: E402
                                     where_active)
from repro_torch.core.protocol import ProtocolResult  # noqa: E402
from repro_torch.rl import casestudy  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

K = 16
PLANS = {"dense": "dense-xla", "sparse": "sparse-pallas"}
F32_ULP = np.finfo(np.float32).eps


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 40)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def _t(p):
    return None if p is None else {k: torch.from_numpy(np.asarray(v))
                                   for k, v in p.items()}


def _j(p):
    return None if p is None else {k: jnp.asarray(np.asarray(v))
                                   for k, v in p.items()}


def _np(p):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in p.items()}


def _atol(x):
    return 1e-5 + 4 * F32_ULP * float(np.abs(x).max())


def _assert_params_close(ours, theirs, like):
    ours, theirs = _np(ours), _np(theirs)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                   atol=_atol(like[k]), err_msg=k)


def _graph(mod, kind):
    if kind == "dropout":
        return mod.GraphProcess.dropout(0.3, seed=1)
    if kind == "schedule":
        rng = np.random.default_rng(4)
        return mod.GraphProcess.schedule(rng.uniform(size=(3, K, K)) < 0.6)
    return None


def _agents(mod, kind):
    if kind == "bernoulli":
        return mod.AgentProcess.bernoulli(0.7, seed=2)
    if kind == "straggler":
        return mod.AgentProcess.straggler(K, seed=3, scale=0.3)
    if kind == "arrival":
        return mod.AgentProcess.arrival(np.arange(K) % 4)
    if kind == "always_on":
        return mod.AgentProcess.always_on()
    return None


def _engines(plan, codec=None, graph=None, agents=None, **kw):
    topo = topology.small_world(K, k=4, seed=1)
    jt = jtopo.small_world(K, k=4, seed=1)
    eng = ConsensusEngine(topo, codec=codec, plan=plan,
                          graph=_graph(topology, graph),
                          agents=_agents(topology, agents), **kw)
    jeng = JEngine(jt, codec=codec, plan=PLANS[plan],
                   graph=_graph(jtopo, graph), agents=_agents(jtopo, agents),
                   **kw)
    return eng, jeng


@pytest.mark.parametrize("graph", ["dropout", "schedule"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_round_survival_matches_jax(plan, graph):
    eng, jeng = _engines(plan, graph=graph)
    ts = torch.arange(2, 7)
    grid = eng.round_survival(ts)
    for i, t in enumerate(range(2, 7)):
        want = np.asarray(jeng.round_survival(t))
        got = eng.round_survival(t, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(grid[i].numpy(), want)
    mask = np.random.default_rng(0).uniform(size=(K, K)) < 0.5
    np.testing.assert_array_equal(
        eng.round_survival(mask=torch.from_numpy(mask)).numpy(),
        np.asarray(jeng.round_survival(mask=jnp.asarray(mask))))
    if plan == "sparse":
        idx, valid = eng.lane_structure()
        jidx, jvalid = jeng.lane_structure()
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(valid, jvalid)


@pytest.mark.parametrize("decay", [1.0, 0.9])
@pytest.mark.parametrize("agents", ["bernoulli", "straggler", "arrival"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_async_round_matches_jax(plan, agents, decay):
    """act, delivered and ages equal; weights within one f32 ulp."""
    eng, jeng = _engines(plan, graph="dropout", agents=agents, tau=2,
                         staleness_decay=decay)
    age = eng.init_async_state(device="cpu").age
    jage = jeng.init_async_state().age
    for t in range(6):
        ar, jar = eng.async_round(t, age), jeng.async_round(t, jage)
        for name in ("act", "delivered", "age"):
            np.testing.assert_array_equal(getattr(ar, name).numpy(),
                                          np.asarray(getattr(jar, name)),
                                          err_msg=f"{name} round {t}")
        w, jw = ar.weights.numpy(), np.asarray(jar.weights)
        assert w.dtype == np.float32
        np.testing.assert_array_max_ulp(w, jw, maxulp=1)
        if decay == 1.0:
            assert set(np.unique(w)) <= {0.0, 1.0}
        age, jage = ar.age, jar.age
    # the chunk form: act and link rows drawn for many rounds at once
    acts = eng.availability(torch.arange(6))
    links = eng.round_survival(torch.arange(6))
    age = eng.init_async_state(device="cpu").age
    for t in range(6):
        a1 = eng.async_round(t, age)
        a2 = eng.async_round(t, age, act=acts[t], link=links[t])
        for x, y in zip(a1, a2):
            assert torch.equal(x, y)
        age = a1.age


@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
@pytest.mark.parametrize("graph", ["dropout", "schedule"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_lockstep_step_t_matches_jax(plan, graph, codec):
    eng, jeng = _engines(plan, codec=codec, graph=graph)
    p = _params(1)
    st = eng.init_state(_t(p))
    for t in range(3):
        jst = None if st is None else _j(_np(st))
        out, st = eng.step(_t(p), st, t=t)
        jout, jst = jeng.step(_j(p), jst, t=t)
        _assert_params_close(out, jout, p)
        assert (st is None) == (jst is None) == (codec is None)
        if st is not None:
            _assert_params_close(st, jst, p)
        p = _np(out)


@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
@pytest.mark.parametrize("graph", [None, "dropout"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_async_step_matches_jax(plan, graph, codec):
    eng, jeng = _engines(plan, codec=codec, graph=graph, agents="bernoulli",
                         tau=2, staleness_decay=0.9)
    p = _params(2)
    ast = eng.init_async_state(device="cpu")
    st = eng.init_state(_t(p))
    for t in range(4):
        jast = JAsyncState(jnp.asarray(ast.clock.numpy()),
                           jnp.asarray(ast.age.numpy()))
        jst = None if st is None else _j(_np(st))
        out, st, ast, ar = eng.async_step(_t(p), st, t=t, state=ast)
        jout, jst, jast, jar = jeng.async_step(_j(p), jst, t=t, state=jast)
        _assert_params_close(out, jout, p)
        if st is not None:
            _assert_params_close(st, jst, p)
        np.testing.assert_array_equal(ast.clock.numpy(), np.asarray(jast.clock))
        np.testing.assert_array_equal(ast.age.numpy(), np.asarray(jast.age))
        sleeping = ~ar.act.numpy()
        for k in p:                     # sleeping agents hold bit for bit
            np.testing.assert_array_equal(out[k].numpy()[sleeping],
                                          p[k][sleeping])
        p = _np(out)


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_scan_rounds_matches_jax(plan, codec):
    """Three rounds of links fading and agents sleeping, one call each."""
    eng, jeng = _engines(plan, codec=codec, graph="dropout",
                         agents="bernoulli", tau=2, staleness_decay=0.9)
    p = _params(3)
    out, st = eng.scan_rounds(_t(p), rounds=3, t0=2)
    jout, jst = jeng.scan_rounds(_j(p), rounds=3, t0=2)
    _assert_params_close(out, jout, p)
    if codec is not None:
        _assert_params_close(st, jst, p)


@pytest.mark.parametrize("agents", [None, "bernoulli"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_scan_rounds_equals_its_steps(plan, agents):
    """Within the port: scan_rounds gives the bits of the same rounds
    driven one call at a time (its draws are made for all rounds at once,
    the calls' one round at a time)."""
    kw = dict(tau=1, staleness_decay=0.8) if agents else {}
    eng, _ = _engines(plan, codec="int8", graph="dropout", agents=agents,
                      **kw)
    p = _t(_params(4))
    out, st = eng.scan_rounds(p, rounds=4, t0=5)
    q, qs = p, eng.init_state(p)
    ast = eng.init_async_state(device="cpu") if agents else None
    for t in range(5, 9):
        if agents:
            q, qs, ast, _ = eng.async_step(q, qs, t=t, state=ast)
        else:
            q, qs = eng.step(q, qs, t=t)
    for k in p:
        assert torch.equal(out[k], q[k]) and torch.equal(st[k], qs[k])


@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
@pytest.mark.parametrize("graph", [None, "dropout"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_always_on_reduces_to_lockstep_bitwise(plan, graph, codec):
    topo = topology.small_world(K, k=4, seed=1)
    g = _graph(topology, graph)
    lock = ConsensusEngine(topo, codec=codec, plan=plan, graph=g)
    asy = ConsensusEngine(topo, codec=codec, plan=plan, graph=g,
                          agents=topology.AgentProcess.always_on())
    p = _t(_params(5))
    a, sa = lock.scan_rounds(p, rounds=3)
    b, sb = asy.scan_rounds(p, rounds=3)
    for k in p:
        assert torch.equal(a[k], b[k])
        if codec is not None:
            assert torch.equal(sa[k], sb[k])


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_dead_round_is_a_bitwise_noop(plan, codec):
    eng = ConsensusEngine(topology.small_world(K, k=4, seed=1), codec=codec,
                          plan=plan, graph=topology.GraphProcess.dropout(0.2),
                          agents=topology.AgentProcess.departure(np.zeros(K)))
    p = _t(_params(6))
    st = None if codec is None else {k: torch.full_like(v, 0.01)
                                     for k, v in p.items()}
    out, st2, ast, ar = eng.async_step(p, st, t=0,
                                       state=eng.init_async_state(device="cpu"))
    assert not ar.act.any() and not ar.delivered.any()
    assert float(ar.weights.abs().max()) == 0.0
    for k in p:
        assert torch.equal(out[k], p[k])
        if codec is not None:
            assert torch.equal(st2[k], st[k])
    assert not ast.clock.any() and bool((ast.age == 1).all())


def test_where_active_selects_rows():
    new = {"w": torch.ones(3, 2)}
    old = {"w": torch.zeros(3, 2)}
    got = where_active(torch.tensor([True, False, True]), new, old)
    assert got["w"].tolist() == [[1, 1], [0, 0], [1, 1]]


def _raises_like(fn, jfn, exc=ValueError):
    """Both packages refuse with the same message (up to the package
    name in the text)."""
    with pytest.raises(exc) as ours:
        fn()
    with pytest.raises(exc) as theirs:
        jfn()
    def norm(e):
        return (str(e.value).replace("repro_torch.", "repro.")
                .replace("'sparse-pallas'", "'sparse'")
                .replace("'dense-xla'", "'dense'"))
    assert norm(ours) == norm(theirs)


def test_engine_refusals_mirror_jax():
    topo, jt = topology.ring(K), jtopo.ring(K)
    on, jon = topology.AgentProcess.always_on(), jtopo.AgentProcess.always_on()
    pairs = [
        (lambda: ConsensusEngine(topo, tau=3), lambda: JEngine(jt, tau=3)),
        (lambda: ConsensusEngine(topo, agents=on, tau=-1),
         lambda: JEngine(jt, agents=jon, tau=-1)),
        (lambda: ConsensusEngine(topo, agents=on, staleness_decay=0.0),
         lambda: JEngine(jt, agents=jon, staleness_decay=0.0)),
        (lambda: ConsensusEngine(
            topo, agents=topology.AgentProcess.arrival(np.zeros(K + 1))),
         lambda: JEngine(jt, agents=jtopo.AgentProcess.arrival(
             np.zeros(K + 1)))),
        (lambda: ConsensusEngine(topo.mixing(), agents=on),
         lambda: JEngine(jt.mixing(), agents=jon)),
        (lambda: ConsensusEngine(topo.mixing(),
                                 graph=topology.GraphProcess.dropout(0.1)),
         lambda: JEngine(jt.mixing(), graph=jtopo.GraphProcess.dropout(0.1))),
        (lambda: ConsensusEngine(topo, graph=topology.GraphProcess.schedule(
            np.ones((2, 4, 4), bool))),
         lambda: JEngine(jt, graph=jtopo.GraphProcess.schedule(
             np.ones((2, 4, 4), bool)))),
        (lambda: ConsensusEngine(topo, plan="sparse").init_async_state(),
         lambda: JEngine(jt, plan="sparse-pallas").init_async_state()),
    ]
    for fn, jfn in pairs:
        _raises_like(fn, jfn)
    with pytest.raises(TypeError, match="AgentProcess.always_on()"):
        ConsensusEngine(topo, agents=object())
    with pytest.raises(TypeError, match="AgentProcess.always_on()"):
        JEngine(jt, agents=object())
    # tau=inf is the unbounded bound
    assert ConsensusEngine(topo, agents=on, tau=float("inf")).tau is None
    # round-level refusals
    for plan in ("dense", "sparse"):
        eng, jeng = _engines(plan, graph="dropout", agents="bernoulli")
        p = _params()
        for fn, jfn in (
                (lambda: eng.step(_t(p), t=0), lambda: jeng.step(_j(p), t=0)),
                (lambda: eng.async_step(_t(p), t=0),
                 lambda: jeng.async_step(_j(p), t=0))):
            with pytest.raises(ValueError) as ours:
                fn()
            with pytest.raises(ValueError) as theirs:
                jfn()
            assert str(ours.value).split(":")[0] == \
                str(theirs.value).split(":")[0]
        lock, jlock = _engines(plan, graph="dropout")
        _raises_like(lambda: lock.step(_t(p)), lambda: jlock.step(_j(p)))
        with pytest.raises(ValueError, match="agents=None"):
            lock.async_round(0, torch.zeros(1, dtype=torch.int32))
        # telemetry= records one row per round (no longer refused)
        tel = Telemetry()
        eng.scan_rounds(_t(p), rounds=2, telemetry=tel)
        assert [e["round"] for e in tel.events(driver="consensus")] == [0, 1]
        with pytest.raises(ValueError, match="rounds="):
            eng.scan_rounds(_t(p))


def _jax_replay(base, p, seed, proc, rounds, ep, codec):
    """The JAX package's post-hoc bill (``CaseStudy.adapt_task``)."""
    drops = (jtopo.dropout(base, p, seed=seed, rounds=rounds) if p > 0
             else [base] * rounds)
    acts = jtopo.availability_stream(proc, base.K, rounds)
    total = 0.0
    for t_r, a in zip(drops, acts):
        m = (np.asarray(t_r.adjacency)
             & np.asarray(a)[:, None] & np.asarray(a)[None, :])
        billed = jtopo.Topology(
            f"{base.name}~billed", m,
            np.where(m, np.asarray(base.link_class), jtopo.NONE))
        total += billed.round_comm_joules(ep, codec=codec)
    return float(total)


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("fam", ["cluster", "star", "hierarchical"])
def test_billing_replay_matches_jax(fam, codec):
    """The delivered-wire bill over given rounds and streams equals the
    JAX package's replay in float64, and E_FL_comm takes the measured
    joules exactly as the JAX package's ProtocolResult does."""
    Kb = 8
    base, jbase = topology.make(fam, Kb), jtopo.make(fam, Kb)
    ep, jep = energy.paper_calibrated("fig3"), jen.paper_calibrated("fig3")
    jc = jcomms.resolve_codec(codec)
    from repro_torch.comms import codecs
    c = codecs.resolve_codec(codec)
    for p, proc in ((0.3, None), (0.0, "bernoulli"), (0.3, "bernoulli"),
                    (0.3, "straggler")):
        ap = (None if proc is None else
              topology.AgentProcess.bernoulli(0.6, seed=1) if proc == "bernoulli"
              else topology.AgentProcess.straggler(Kb, seed=1, scale=0.3))
        jap = (None if proc is None else
               jtopo.AgentProcess.bernoulli(0.6, seed=1) if proc == "bernoulli"
               else jtopo.AgentProcess.straggler(Kb, seed=1, scale=0.3))
        rounds = 7
        drops = (topology.dropout(base, p, seed=2, rounds=rounds) if p > 0
                 else [base] * rounds)
        acts = topology.availability_stream(ap, Kb, rounds)
        ours = casestudy.delivered_comm_joules(
            base, [d.adjacency & a[:, None] & a[None, :]
                   for d, a in zip(drops, acts)], ep, c)
        theirs = _jax_replay(jbase, p, 2, jap, rounds, jep, jc)
        assert ours == theirs
        assert ours <= rounds * base.round_comm_joules(ep, codec=c)
        res = ProtocolResult(t0=3, rounds_per_task=[rounds, 2], meta_history=[],
                             fl_histories=[], energy_params=ep, Q=3,
                             cluster_topology=base, codec=c,
                             fl_comm_joules_measured=[ours, 0.5])
        jres = JResult(t0=3, rounds_per_task=[rounds, 2], meta_history=[],
                       fl_histories=[], energy_params=jep, Q=3,
                       cluster_topology=jbase, codec=jc,
                       fl_comm_joules_measured=[theirs, 0.5])
        assert res.E_FL_comm == jres.E_FL_comm
        assert res.E_total == jres.E_total


def test_case_study_dynamic_bill_and_freeze():
    """A tiny dynamic case study (paper-DQN cut to width 16, two layers):
    the bill equals the JAX package's replay of the same streams over the
    rounds used, the delivered lanes drawn during the rounds give the same
    bill, a robot that never wakes keeps its initial params, and
    fl_comm_joules_measured follows the JAX package's rule."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("paper-dqn"), d_model=16, num_layers=2)
    common = dict(cfg=cfg, plan="sparse-pallas", device="cpu", inner_steps=2,
                  fl_local_steps=2, chunk=2)
    gen = torch.Generator().manual_seed(0)
    cs = casestudy.CaseStudy(
        codec="int8", dropout_p=0.3, dropout_seed=4, tau=1,
        availability=topology.AgentProcess.bernoulli(0.75, seed=1),
        staleness_decay=0.9, **common)
    init = cs.init_params(gen)
    _, t_i, hist = cs.adapt_task(gen, 2, init, max_rounds=3)
    assert 1 <= t_i <= 3 and len(hist) == t_i
    jproc = jtopo.AgentProcess.bernoulli(0.75, seed=1 + 2)
    want = _jax_replay(jtopo.clusters(1, 2), 0.3, 4 + 2, jproc, t_i,
                       jen.paper_calibrated("fig3"),
                       jcomms.resolve_codec("int8"))
    assert cs.last_adapt_comm_joules == want
    idx, _ = cs.engine.lane_structure()
    masks = []
    for deliv in cs.fl_delivered[2]:
        m = np.zeros((2, 2), bool)
        m[np.arange(2)[:, None], idx] |= deliv
        masks.append(m)
    assert casestudy.delivered_comm_joules(
        cs.cluster_topology, masks, cs.energy_params, cs.codec) == want
    # robot 0 never wakes: its params and residuals never move
    sleepy = casestudy.CaseStudy(
        availability=topology.AgentProcess.departure([0, 100]), **common)
    stacked, t_s, _ = sleepy.adapt_task(gen, 0, init, max_rounds=2)
    for k in init:
        assert torch.equal(stacked[k][0], init[k])
    assert sleepy.last_adapt_comm_joules == 0.0
    res = sleepy.run(gen, 1, max_rounds=2)
    assert res.fl_comm_joules_measured is None       # availability only
    res = cs.run(gen, 1, max_rounds=2)
    assert res.fl_comm_joules_measured is not None
    assert res.E_FL_comm == res.fl_comm_joules_measured
