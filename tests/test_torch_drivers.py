"""The port's round drivers: ``run_fl_until`` / ``run_fl_until_scan``,
``fedavg_round``, ``maml_train`` / ``maml_train_scan`` and
``MTLProtocol``.

Within the port the chunked drivers are held BIT for bit to their
host-loop twins (params, t_i, history, EF codec state) across chunk sizes
{1, 7, 32}, plans and codecs, including a target hit mid-chunk, a target
never reached, ``eval_every`` and the freeze after the hit.

Against the JAX package, on the same numpy-made params and samplers that
index a numpy table by the round (both packages draw nothing then): the
quadratic toy of ``tests/test_scan_drivers.py`` (codec None) gives the same
t_i, and history and params within 1e-5, on a static ring and on one whose
links fade and whose agents sleep (the telemetry rows' counts and joules
then equal JAX's); ``fedavg_round`` and a
``maml_train`` run within 1e-5 (f32 sums in other orders); the
``MTLProtocol`` toy of ``tests/test_system.py`` gives the same t_i and
E_total, and its meta history within 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtl  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import maml as jmaml  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro.core.multitask import ClusterNetwork as JNetwork  # noqa: E402
from repro.core.protocol import MTLProtocol as JProtocol  # noqa: E402
from repro_torch import telemetry as tl  # noqa: E402
from repro_torch.core import federated, maml, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.core.multitask import ClusterNetwork  # noqa: E402
from repro_torch.core.protocol import MTLProtocol  # noqa: E402

K = 8
TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(11)
#: quadratic toy (tests/test_scan_drivers.py): K agents, 3 local steps,
#: each pulling w toward a round's sampled targets
TGT = (RNG.standard_normal((40, K, 3, 1, 6)) * 0.1).astype(np.float32)
W0 = RNG.standard_normal((K, 6)).astype(np.float32)
B0 = RNG.standard_normal((K, 3)).astype(np.float32)


def _loss(p, b):
    return ((p["w"] - b["tgt"]) ** 2).mean()


def _sampler(_generator, t):
    return {"tgt": torch.from_numpy(TGT[t])}


def _stacked():
    return {"w": torch.from_numpy(W0.copy()), "b": torch.from_numpy(B0.copy())}


def _target(thr):
    def target(sp):
        m = sp["w"].square().mean()
        return m < thr, m
    return target


def _run(driver, engine, thr, *, max_rounds=21, **kw):
    return driver(_loss, _stacked(), _sampler, engine, 0.3,
                  target_fn=_target(thr), max_rounds=max_rounds,
                  generator=torch.Generator().manual_seed(7),
                  return_state=True, **kw)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_fl_scan_matches_host_loop(plan, codec, chunk):
    """run_fl_until_scan == run_fl_until bit for bit, with the hit
    strictly inside the run (and mid-chunk at chunk 7)."""
    eng = ConsensusEngine(topology.ring(K), codec=codec, plan=plan)
    _, _, probe, _ = _run(federated.run_fl_until_scan, eng, -1.0, chunk=32)
    thr = probe[2] * 0.999
    p_h, t_h, h_h, s_h = _run(federated.run_fl_until, eng, thr)
    assert 1 < t_h < 21
    p_s, t_s, h_s, s_s = _run(federated.run_fl_until_scan, eng, thr,
                              chunk=chunk)
    assert (t_s, h_s) == (t_h, h_h)
    assert len(h_s) == t_s
    assert _equal(p_s, p_h) and _equal(s_s, s_h)
    assert (s_s is None) == (codec is None)


def test_fl_scan_never_reached_runs_max_rounds():
    eng = ConsensusEngine(topology.ring(K), plan="sparse")
    p_h, t_h, h_h, _ = _run(federated.run_fl_until, eng, -1.0, max_rounds=10)
    assert t_h == 10 and len(h_h) == 10
    for chunk in (3, 4, 32):
        p_s, t_s, h_s, _ = _run(federated.run_fl_until_scan, eng, -1.0,
                                max_rounds=10, chunk=chunk)
        assert (t_s, h_s) == (10, h_h) and _equal(p_s, p_h)


def test_fl_scan_eval_every_matches_host():
    """eval_every = 2: evaluation happens on the same rounds in both
    drivers and t_i lands on an evaluated round."""
    eng = ConsensusEngine(topology.ring(K), codec="int8")
    _, _, probe, _ = _run(federated.run_fl_until_scan, eng, -1.0, chunk=32)
    thr = probe[3] * 0.999
    p_h, t_h, h_h, s_h = _run(federated.run_fl_until, eng, thr,
                              eval_every=2)
    assert t_h % 2 == 0 and len(h_h) == t_h // 2
    p_s, t_s, h_s, s_s = _run(federated.run_fl_until_scan, eng, thr,
                              eval_every=2, chunk=5)
    assert (t_s, h_s) == (t_h, h_h)
    assert _equal(p_s, p_h) and _equal(s_s, s_h)


def test_fl_scan_freeze_pins_params_after_hit():
    """A run that hits mid-chunk ends in the state of a run cut at
    max_rounds = t_i: the rounds after the hit changed nothing."""
    eng = ConsensusEngine(topology.ring(K), codec="int8", plan="sparse")
    _, _, probe, _ = _run(federated.run_fl_until_scan, eng, -1.0, chunk=32)
    thr = probe[2] * 0.999
    p_long, t_long, _, s_long = _run(federated.run_fl_until_scan, eng, thr,
                                     chunk=21)
    assert t_long < 21
    p_cut, t_cut, _, s_cut = _run(federated.run_fl_until_scan, eng, thr,
                                  max_rounds=t_long, chunk=t_long)
    assert t_cut == t_long
    assert _equal(p_cut, p_long) and _equal(s_cut, s_long)


def _jloss(p, b):
    return jnp.mean((p["w"] - b["tgt"]) ** 2)


def _jsampler(_key, t):
    return {"tgt": jnp.asarray(TGT)[t]}


def test_fl_drivers_match_jax_on_quadratic_toy():
    eng = ConsensusEngine(topology.ring(K), plan="sparse")
    _, _, probe, _ = _run(federated.run_fl_until_scan, eng, -1.0, chunk=32)
    thr = float(probe[3] + probe[4]) / 2     # far from either side
    p, t_i, hist, _ = _run(federated.run_fl_until_scan, eng, thr, chunk=4)
    jeng = JEngine(jtopo.ring(K), plan="sparse-pallas")

    def jtarget(sp):
        m = jnp.mean(jnp.square(sp["w"]))
        return m < thr, m

    jp, jt, jh = jfed.run_fl_until_scan(
        _jloss, {"w": jnp.asarray(W0), "b": jnp.asarray(B0)}, _jsampler,
        jeng, 0.3, target_fn=jtarget, max_rounds=21,
        key=jax.random.PRNGKey(0), chunk=4)
    assert t_i == jt == 5
    np.testing.assert_allclose(hist, jh, **TOL)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **TOL)


#: telemetry fields that depend only on the draws (``metric`` and
#: ``disagreement`` are f32 sums, held within TOL instead)
ROW_EXACT = ("type", "driver", "round", "live", "reached", "K", "topology",
             "n_sl", "n_ul", "n_dl", "edges", "n_active", "max_age",
             "agent_sl", "agent_ul", "agent_dl", "wire_bits", "joules_sl",
             "joules_ul", "joules_dl", "joules", "agent_joules")


def _fading_async(mod):
    return dict(graph=mod.GraphProcess.dropout(0.3, seed=3),
                agents=mod.AgentProcess.bernoulli(0.7, seed=4), tau=2,
                staleness_decay=0.9)


def test_fl_drivers_match_jax_on_fading_links_and_sleeping_agents():
    """The async, fading-link branch of the chunked driver against JAX's:
    the chunk's draws, ``async_round``, the freeze after a mid-chunk hit
    and the AsyncState carried across chunks (chunk 4, hit in round 6).
    t_i and every row's link and per-agent counts and joules are equal;
    history, params and disagreement within 1e-5."""
    eng = ConsensusEngine(topology.ring(K), plan="sparse",
                          **_fading_async(topology))
    _, _, probe, _ = _run(federated.run_fl_until_scan, eng, -1.0, chunk=32)
    assert probe[5] < min(probe[:5])
    thr = float(probe[4] + probe[5]) / 2     # far from either side
    tel = tl.Telemetry()
    p, t_i, hist, _ = _run(federated.run_fl_until_scan, eng, thr, chunk=4,
                           telemetry=tel)
    jeng = JEngine(jtopo.ring(K), plan="sparse-pallas",
                   **_fading_async(jtopo))
    jtel = jtl.Telemetry()

    def jtarget(sp):
        m = jnp.mean(jnp.square(sp["w"]))
        return m < thr, m

    jp, jt, jh = jfed.run_fl_until_scan(
        _jloss, {"w": jnp.asarray(W0), "b": jnp.asarray(B0)}, _jsampler,
        jeng, 0.3, target_fn=jtarget, max_rounds=21,
        key=jax.random.PRNGKey(0), chunk=4, telemetry=jtel)
    assert t_i == jt == 6
    np.testing.assert_allclose(hist, jh, **TOL)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **TOL)
    ev, jev = tel.events(driver="fl"), jtel.events(driver="fl")
    assert len(ev) == len(jev) == t_i
    for i, (e, je) in enumerate(zip(ev, jev)):
        for f in ROW_EXACT:
            assert e[f] == je[f], (f, i)
        np.testing.assert_allclose(e["metric"], je["metric"], **TOL)
        np.testing.assert_allclose(e["disagreement"], je["disagreement"],
                                   rtol=1e-5)
    # the draws really vary: links fade and agents sleep
    assert len({e["edges"] for e in ev}) > 1
    assert min(e["n_active"] for e in ev) < K
    assert tel.joules() == jtel.joules()


def test_fedavg_round_matches_jax():
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((6,)).astype(np.float32),
         "b": rng.standard_normal((3,)).astype(np.float32)}
    batches = (rng.standard_normal((K, 3, 1, 6)) * 0.1).astype(np.float32)
    weights = rng.uniform(1, 5, K).astype(np.float32)
    got = federated.fedavg_round(
        _loss, {k: torch.from_numpy(v) for k, v in g.items()},
        {"tgt": torch.from_numpy(batches)}, torch.from_numpy(weights), 0.3)
    want = jfed.fedavg_round(
        _jloss, {k: jnp.asarray(v) for k, v in g.items()},
        {"tgt": jnp.asarray(batches)}, jnp.asarray(weights), 0.3)
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == g[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)


# -- MAML drivers ----------------------------------------------------------------

D = 5
XS = RNG.standard_normal((12, 2, 2, 8, D)).astype(np.float32)   # support
XQ = RNG.standard_normal((12, 2, 8, D)).astype(np.float32)      # query
SHIFT = np.array([0.5, -1.0], np.float32)[:, None, None]


def _mloss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean()


def _task_batches(t, mod):
    """Round t's support and query of the Q = 2 regression tasks (y =
    Σx + a per-task shift), as ``mod`` arrays."""
    ys = XS[t].sum(-1, keepdims=True) + SHIFT[:, None]
    yq = XQ[t].sum(-1, keepdims=True) + SHIFT
    return ({"x": mod(XS[t]), "y": mod(ys)}, {"x": mod(XQ[t]), "y": mod(yq)})


def _sample_tasks(_generator, t):
    return _task_batches(t, torch.from_numpy)


def _mparams():
    return {"w": torch.zeros(D, 1), "b": torch.zeros(1)}


MAML_KW = dict(rounds=5, inner_lr=0.1, outer_lr=0.1, inner_steps=2)


@pytest.mark.parametrize("first_order", [True, False])
def test_maml_scan_matches_host_loop(first_order):
    seen = []
    p_h, h_h = maml.maml_train(
        _mloss, _mparams(), _sample_tasks, first_order=first_order,
        callback=lambda t, p, m: seen.append((t, float(m["meta_loss"]))),
        **MAML_KW)
    assert [t for t, _ in seen] == list(range(5))
    assert [x for _, x in seen] == h_h
    for chunk in (2, 32):
        p_s, h_s = maml.maml_train_scan(_mloss, _mparams(), _sample_tasks,
                                        first_order=first_order, chunk=chunk,
                                        **MAML_KW)
        assert h_s == h_h and _equal(p_s, p_h)
    assert h_h[-1] < h_h[0]
    # telemetry: maml events in both modes, the same bits
    for mode in ("buffered", "streaming"):
        tel = tl.Telemetry(mode=mode, sinks=(tl.MemorySink(),))
        p_t, h_t = maml.maml_train_scan(
            _mloss, _mparams(), _sample_tasks, first_order=first_order,
            chunk=2, telemetry=tel, **MAML_KW)
        assert h_t == h_h and _equal(p_t, p_h)
        ev = tel.events(driver="maml")
        assert [e["round"] for e in ev] == list(range(5))
        assert [e["meta_loss"] for e in ev] == h_h
        assert tel.sinks[0].events == ev
        assert all(tl.validate_event(e) == [] for e in ev)


def test_maml_train_matches_jax():
    def jsample(_key, t):
        return _task_batches(t, jnp.asarray)

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    p, hist = maml.maml_train(_mloss, _mparams(), _sample_tasks, **MAML_KW)
    jp, jhist = jmaml.maml_train_scan(
        jloss, {"w": jnp.zeros((D, 1)), "b": jnp.zeros((1,))}, jsample,
        chunk=5, **MAML_KW)
    np.testing.assert_allclose(hist, jhist, **TOL)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), **TOL)


# -- MTLProtocol -----------------------------------------------------------------

W1 = (RNG.standard_normal((2, 16)) * 0.5).astype(np.float32)
W2 = (RNG.standard_normal((16, 1)) * 0.5).astype(np.float32)
XP = RNG.standard_normal((2, 5, 16, 2)).astype(np.float32)   # per task
#: per-task loss targets, each reached a few rounds into the run
GOAL = (0.025, 0.405)


def _task_y(task_id, x):
    return np.sin(x[..., :1] + task_id) + 0.5 * task_id * x[..., 1:2]


def _proto_batch(task_id, steps):
    x = XP[task_id, :steps] if steps else XP[task_id, 4]
    return x, _task_y(task_id, x).astype(np.float32)


def _torch_protocol(telemetry=None, codec=None):
    def loss_fn(p, b):
        return ((torch.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2
                ).mean()

    def sample_support(_g, task_id, steps):
        x, y = _proto_batch(task_id, steps)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def sample_query(_g, task_id):
        x, y = _proto_batch(task_id, 0)
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}

    def target_fn(p, task_id):
        loss = loss_fn(p, sample_query(None, task_id))
        return loss < GOAL[task_id], -loss

    return MTLProtocol(
        loss_fn=loss_fn,
        init_fn=lambda g: {"w1": torch.from_numpy(W1.copy()),
                           "w2": torch.from_numpy(W2.copy())},
        network=ClusterNetwork(num_tasks=2, devices_per_cluster=2,
                               meta_task_ids=(0,)),
        sample_support=sample_support, sample_query=sample_query,
        target_fn=target_fn, inner_lr=0.05, outer_lr=0.02, fl_lr=0.05,
        inner_steps=3, fl_local_steps=5, codec=codec, chunk=4,
        telemetry=telemetry)


def test_mtl_protocol_matches_jax():
    """The generic protocol on the toy regression MTL network of
    tests/test_system.py, with samplers that ignore their key/generator:
    the same t_i and E_total as the JAX package, meta history within
    1e-5; telemetry leaves the run's bits alone and its per-task joules
    add up to the static per-round bill."""
    res = _torch_protocol().run(torch.Generator().manual_seed(0), 5,
                                max_rounds=30)

    def jloss(p, b):
        return jnp.mean((jnp.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2)

    def jsupport(_k, task_id, steps):
        x, y = _proto_batch(task_id, steps)
        return {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    def jquery(_k, task_id):
        x, y = _proto_batch(task_id, 0)
        return {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    def jtarget(p, task_id):
        loss = jloss(p, jquery(None, task_id))
        return loss < GOAL[task_id], -loss

    jproto = JProtocol(
        loss_fn=jloss,
        init_fn=lambda k: {"w1": jnp.asarray(W1), "w2": jnp.asarray(W2)},
        network=JNetwork(num_tasks=2, devices_per_cluster=2,
                         meta_task_ids=(0,)),
        sample_support=jsupport, sample_query=jquery, target_fn=jtarget,
        inner_lr=0.05, outer_lr=0.02, fl_lr=0.05, inner_steps=3,
        fl_local_steps=5, chunk=4)
    jres = jproto.run(jax.random.PRNGKey(0), t0=5, max_rounds=30)
    assert len(res.meta_history) == 5
    assert 1 < min(res.rounds_per_task) and max(res.rounds_per_task) < 30
    assert res.rounds_per_task == jres.rounds_per_task
    np.testing.assert_allclose(res.meta_history, jres.meta_history, **TOL)
    for h, jh in zip(res.fl_histories, jres.fl_histories):
        np.testing.assert_allclose(h, jh, **TOL)
    assert res.E_total == jres.E_total
    assert res.summary() == jres.summary()

    tel = tl.Telemetry()
    proto = _torch_protocol(telemetry=tel)
    res_t = proto.run(torch.Generator().manual_seed(0), 5, max_rounds=30)
    assert res_t.rounds_per_task == res.rounds_per_task
    assert res_t.meta_history == res.meta_history
    assert res_t.fl_histories == res.fl_histories
    per_round = proto.engine.round_comm_joules(proto.energy_params)
    for tid, t_i in enumerate(res.rounds_per_task):
        ev = [e for e in tel.events(driver="fl") if e["task_id"] == tid]
        assert len(ev) == t_i
        assert all(e["joules"] == per_round for e in ev)
        assert tel.joules(task_id=tid) == pytest.approx(t_i * per_round,
                                                        rel=1e-12)
    assert len(tel.events(driver="maml")) == 5


def test_mtl_protocol_second_order_prices_beta_2():
    proto = _torch_protocol()
    assert proto.energy_params.beta != 2.0
    second = MTLProtocol(
        loss_fn=proto.loss_fn, init_fn=proto.init_fn, network=proto.net,
        sample_support=proto.sample_support, sample_query=proto.sample_query,
        target_fn=proto.target_fn, first_order=False, codec="int8")
    assert second.energy_params.beta == 2.0
    assert second.engine.plan.kind == "dense"        # K = 2: auto → dense
    assert second.codec is not None and second.codec.stateful
    meta, hist = second.meta_train(torch.Generator().manual_seed(0), 2)
    assert len(hist) == 2 and set(meta) == {"w1", "w2"}
    _, t_i, h = second.adapt_task(torch.Generator().manual_seed(1), 1, meta,
                                  max_rounds=3)
    assert 1 <= t_i <= 3 and len(h) == t_i
