"""The port's LM training slice against the JAX package, on the same
numpy-made inputs and on JAX parameters carried across by
``repro_torch.convert``:

* three ``make_train_step`` steps against the reference's;
* one federated round against the reference's leaf functions
  (``jax.grad`` + clip + SGD per agent, then ``engine.step``) on the dense
  and sparse plans, codec None and bf16 consensus;
* ``codec.model_bits`` of the population, the Eq.-(11) estimate, the token
  tables and ``select_codec`` ``==`` the reference's;
* chunk 1 against chunk 3, telemetry off against buffered, the same bits,
  every row's joules ``==`` the host replay, sleeping agents held;
* ``auto`` resolving to dense at ``clusters(2, 2)``;
* twins of ``tests/test_system.py``'s trainer tests and
  ``tests/test_topology.py::test_train_federated_prices_four_agent_
  cluster``, and the quickstart and federated_lm twins on the CPU.

The gradients themselves (the kernels' Functions, ``lm_loss`` against
``jax.grad``) are held in ``test_torch_autograd.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comms as jcomms  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro.data import TaskTokenDistribution as JDist  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import comms, telemetry  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import energy, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.data import TaskTokenDistribution, batches  # noqa: E402
from repro_torch.launch import federated_lm, quickstart, steps, train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.rl.casestudy import delivered_comm_joules  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small models run about as fast on one,
    and in a parallel test run (a worker per core) more threads per
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0, d_model=64, **change):
    """The reduced config in both packages (with ``change``), the JAX
    params and the port's stacked-param dict of the same numbers."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch), d_model=d_model),
                               **change)
    cfg = dataclasses.replace(reduced(get_arch(arch), d_model=d_model),
                              **change)
    jp = jtransformer.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jp, device="cpu")


def _tokens(cfg, shape, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., ::5] = -1
    return toks, labels


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_make_train_step_three_steps_match_jax():
    jcfg, cfg, jp, p = _pair("granite-8b", num_kv_heads=2)
    jstep, jopt = jsteps.make_train_step(jcfg, lr=1e-3, clip_norm=1.0)
    jstep = jax.jit(jstep)
    step, opt = steps.make_train_step(cfg, lr=1e-3, clip_norm=1.0)
    jst, st = jopt.init(jp), opt.init(p)
    for i in range(3):
        toks, labels = _tokens(cfg, (2, 32), seed=10 + i)
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels)})
        p, st, m = step(p, st, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(st["step"]) == 3 and st["step"].dtype == torch.int32
    # Adam moves a weight by about lr·g/|g| a step, so where a gradient
    # entry is zero to within f32 rounding the two packages' steps may
    # differ by up to 2·lr: at least 99.9 % of each leaf within 1e-6 of
    # JAX's after 3 steps, and every element within 3 · 2 · lr
    want = params_from_numpy(jp, device="cpu")
    for k in want:
        diff = (p[k] - want[k]).abs()
        assert float((diff <= 1e-6).float().mean()) >= 0.999, k
        assert float(diff.max()) <= 6e-3, k


#: the rest of the LM zoo: reduced whisper (its frames from numpy),
#: xLSTM (mLSTM + sLSTM) and recurrentgemma at one pattern period
ZOO = {"whisper-large-v3": {}, "xlstm-125m": {},
       "recurrentgemma-9b": {"num_layers": 3}}


def _zoo_pair(arch, seed=0):
    """As :func:`_pair`, for any family: the JAX init of its own model."""
    layers = ZOO[arch].get("num_layers", 2)
    jcfg = jreduced(jget_arch(arch), d_model=64, num_layers=layers)
    cfg = reduced(get_arch(arch), d_model=64, num_layers=layers)
    jp = japi.get_model(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("arch", sorted(ZOO))
def test_make_train_step_three_steps_match_jax_zoo(arch):
    """Three Adam steps on whisper (with frames), xLSTM and the hybrid:
    the loss (relatively: whisper's is ~100) and gradient norm of each
    step, then the params, as the transformer's test holds them. Adam
    turns a gradient that is zero to within f32 rounding into a step of
    ±lr whose sign is the rounding's: xLSTM's sLSTM input-gate bias is
    such a leaf (the stabilizer cancels it from c/n: its reference
    gradient is ~1e-10 against 1e-2 for the other gates). So the 1e-6
    agreement is held where some step's reference gradient exceeds 1e-6
    of its leaf's largest, and every element within 3 · 2 · lr."""
    jcfg, cfg, jp, p = _zoo_pair(arch)
    jstep, jopt = jsteps.make_train_step(jcfg, lr=1e-3, clip_norm=1.0)
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda q, b: japi.lm_loss(
        q, jcfg, b["tokens"], b["labels"], embeddings=b.get("frames"))))
    step, opt = steps.make_train_step(cfg, lr=1e-3, clip_norm=1.0)
    jst, st = jopt.init(jp), opt.init(p)
    rng = np.random.default_rng(7)
    signal = {k: torch.zeros(v.shape, dtype=torch.bool) for k, v in p.items()}
    for i in range(3):
        toks, labels = _tokens(cfg, (2, 16), seed=20 + i)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        b = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
        if cfg.family == "encdec":
            frames = (rng.standard_normal(
                (2, cfg.encdec.encoder_seq_len, cfg.d_model)) * 0.02
                ).astype(np.float32)
            jb["frames"], b["frames"] = (jnp.asarray(frames),
                                         torch.from_numpy(frames))
        for k, g in params_from_numpy(jgrad(jp, jb), device="cpu").items():
            signal[k] |= g.abs() > 1e-6 * float(g.abs().max())
        jp, jst, jm = jstep(jp, jst, jb)
        p, st, m = step(p, st, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = params_from_numpy(jp, device="cpu")
    assert set(p) == set(want)
    for k in want:
        diff = (p[k] - want[k]).abs()
        if bool(signal[k].any()):
            held = diff[signal[k]] <= 1e-6
            assert float(held.float().mean()) >= 0.999, k
        assert float(diff.max()) <= 6e-3, k


# ---------------------------------------------------------------------------
# one federated round against the reference's leaf functions
# ---------------------------------------------------------------------------

AGENTS, TASKS, LOCAL, LR = 4, 2, 2, 0.05


def _jax_local_round(jcfg, stacked, toks, labels):
    """The reference's per-agent local steps (``launch/train.py``'s
    ``local``, vmapped over agents)."""
    def loss_fn(p, b):
        return japi.lm_loss(p, jcfg, b["tokens"], b["labels"])

    def local(p, b):
        def one(p, bb):
            g = jax.grad(loss_fn)(p, bb)
            g, _ = joptim.clip_by_global_norm(g, 1.0)
            return jax.tree.map(
                lambda w, gw: (w.astype(jnp.float32) - LR
                               * gw.astype(jnp.float32)).astype(w.dtype),
                p, g), None
        p, _ = jax.lax.scan(one, p, b)
        return p

    return jax.vmap(local)(stacked, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)})


@pytest.mark.parametrize("plan", ["dense", "sparse"])
@pytest.mark.parametrize("bf16", [False, True])
def test_one_federated_round_matches_reference_leaves(plan, bf16):
    jcfg, cfg, jp, p = _pair("granite-8b", num_kv_heads=2)
    toks, labels = _tokens(cfg, (AGENTS, LOCAL, 2, 16), seed=4)
    jstacked = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (AGENTS,) + x.shape), jp)
    jnew = _jax_local_round(jcfg, jstacked, toks, labels)
    jeng = JEngine(jtopo.clusters(TASKS, AGENTS // TASKS),
                   plan={"dense": "dense-xla", "sparse": "sparse-pallas"}[plan])
    if bf16:
        mixed, _ = jeng.step(jax.tree.map(
            lambda x: x.astype(jnp.bfloat16), jnew))
        jout = jax.tree.map(lambda m, n: m.astype(n.dtype), mixed, jnew)
    else:
        jout, _ = jeng.step(jnew)

    eng = ConsensusEngine(topology.clusters(TASKS, AGENTS // TASKS),
                          plan=plan)
    stacked = {k: v.expand((AGENTS,) + v.shape) for k, v in p.items()}

    def loss_fn(q, t, lab):
        return api.lm_loss(q, cfg, t, lab)

    out, st = train.fl_round(
        eng, loss_fn, stacked, None, None, torch.from_numpy(toks),
        torch.from_numpy(labels), lr=LR,
        consensus_dtype=torch.bfloat16 if bf16 else None)
    assert st is None and stacked == {}            # the population consumed
    want = params_from_numpy(jout, device="cpu")
    local_j = params_from_numpy(jnew, device="cpu")
    for k in want:
        assert out[k].shape == want[k].shape and out[k].dtype == torch.float32
        # the round moved the params (lr 0.05), and by the reference's
        # amount: f32 to 1e-5 of the leaf; bf16 wires to one bf16 rounding
        moved = float((local_j[k] - p[k]).abs().max())
        assert moved > 0 or k.endswith("norm"), k
        tol = (2.0 ** -7 if bf16 else 1e-5) * float(want[k].abs().max())
        assert float((out[k] - want[k]).abs().max()) <= tol, k


def _jax_round_f64(jcfg, jp, toks, labels):
    """The reference's round (local steps, then the engine's step) in
    float64 throughout: x64 on, the config's dtypes f64, and the f32
    casts inside the reference's model, loss and SGD (``jnp.float32``,
    read when each op runs) pointed at f64 while it runs. The exact
    round that the f32 rounds of both packages are measured against (the
    dense plan: every plan applies the same mixing operator)."""
    jcfg = dataclasses.replace(jcfg, dtype="float64", param_dtype="float64")
    f32 = jnp.float32
    try:
        jnp.float32 = jnp.float64
        with jax.enable_x64(True):
            jp = jax.tree.map(lambda x: jnp.asarray(np.asarray(x),
                                                    jnp.float64), jp)
            jstacked = jax.tree.map(lambda x: jnp.broadcast_to(
                x[None], (AGENTS,) + x.shape), jp)
            jnew = _jax_local_round(jcfg, jstacked, toks, labels)
            jeng = JEngine(jtopo.clusters(TASKS, AGENTS // TASKS),
                           plan="dense-xla")
            jout, _ = jeng.step(jnew)
            return jax.tree.map(np.asarray, jout)
    finally:
        jnp.float32 = f32


@pytest.mark.parametrize("arch", ["xlstm-125m", "recurrentgemma-9b"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_one_federated_round_matches_reference_leaves_zoo(arch, plan):
    """xLSTM (its per-layer tuple leaves) and the hybrid (one pattern
    period: the ``periods`` leaves, B3 and B4 in the local steps): one
    round of local SGD and the engine's step against the reference's, with
    the JAX leaf count in the population."""
    jcfg, cfg, jp, p = _zoo_pair(arch)
    assert len(p) == len(jax.tree.leaves(jp))
    toks, labels = _tokens(cfg, (AGENTS, LOCAL, 2, 16), seed=4)
    jstacked = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (AGENTS,) + x.shape), jp)
    jnew = _jax_local_round(jcfg, jstacked, toks, labels)
    jeng = JEngine(jtopo.clusters(TASKS, AGENTS // TASKS),
                   plan={"dense": "dense-xla", "sparse": "sparse-pallas"}[plan])
    jout, _ = jeng.step(jnew)
    eng = ConsensusEngine(topology.clusters(TASKS, AGENTS // TASKS),
                          plan=plan)
    stacked = {k: v.expand((AGENTS,) + v.shape) for k, v in p.items()}
    out, _ = train.fl_round(
        eng, lambda q, t, lab: api.lm_loss(q, cfg, t, lab), stacked, None,
        None, torch.from_numpy(toks).long(), torch.from_numpy(labels).long(),
        lr=LR)
    want = params_from_numpy(jout, device="cpu")
    exact = params_from_numpy(_jax_round_f64(jcfg, jp, toks, labels),
                              device="cpu")
    assert set(out) == set(want)
    for k in want:
        assert out[k].shape == want[k].shape, k
        # the port may sit as far from the exact round as the reference
        # does, plus 1e-5 of the leaf: at seed 4 the reference's own f32
        # round is 1.03e-5 of blocks.0.conv.b's largest from the f64 one
        ref_err = float((want[k].double() - exact[k]).abs().max())
        tol = 1e-5 * float(want[k].abs().max()) + 2 * ref_err
        assert float((out[k] - want[k]).abs().max()) <= tol, k


@pytest.mark.parametrize("layers", [2, 3, 5, 7])
def test_hybrid_stack_params_is_the_jax_leaf_structure(layers):
    """The hybrid's ``stack_params`` gives ``params_from_numpy`` of the
    JAX tree (``periods`` stacked over whole periods, ``rem`` the rest),
    and its forward on that dict equals the module's, with and without
    remat."""
    from repro.models import rglru as jrglru
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import rglru
    jcfg = jreduced(jget_arch("recurrentgemma-9b"), d_model=32,
                    num_layers=layers)
    cfg = reduced(get_arch("recurrentgemma-9b"), d_model=32,
                  num_layers=layers)
    jp = jrglru.init(jax.random.PRNGKey(layers), jcfg)
    model = rglru.init(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(jp, cfg, device="cpu"))
    stacked = rglru.stack_params(model)
    want = params_from_numpy(jp, device="cpu")
    assert set(stacked) == set(want)
    assert all(torch.equal(stacked[k], want[k]) for k in want)
    toks, labels = (torch.from_numpy(a).long()
                    for a in _tokens(cfg, (2, 12), seed=layers))
    with torch.no_grad():
        a = rglru.forward(model, cfg, toks)[0]
        b = rglru.forward(stacked, cfg, toks)[0]
    assert torch.equal(a, b)
    loss = lambda c: (lambda q: api.lm_loss(q, c, toks, labels))  # noqa
    l0, g0 = steps.value_and_grad(loss(cfg), stacked)
    l1, g1 = steps.value_and_grad(
        loss(dataclasses.replace(cfg, remat=True)), stacked)
    assert torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.parametrize("spec", ["int8", "int8:b64", "int4", "bf16"])
def test_model_bits_of_the_population_leaves_equal_jax(spec):
    """The port keeps the JAX leaf structure (``blocks.*`` stacked), so a
    codec's exact wire bits, one scale per leaf (or block) included, are
    the reference's; one leaf per layer would add scales."""
    for layers in (2, 5):
        jcfg = jreduced(jget_arch("granite-8b"), num_layers=layers)
        cfg = reduced(get_arch("granite-8b"), num_layers=layers)
        jp = jax.eval_shape(lambda k: jtransformer.init(k, jcfg),
                            jax.random.PRNGKey(0))
        p = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert len(p) == 12
        want = jcomms.resolve_codec(spec).model_bits(jp)
        assert comms.resolve_codec(spec).model_bits(p) == want


# ---------------------------------------------------------------------------
# the Eq.-(11) estimate, chunks, telemetry, plans
# ---------------------------------------------------------------------------

TINY = dict(rounds=3, agents=AGENTS, tasks=TASKS, local_steps=1, batch=1,
            seq=8, lr=1e-3, device="cpu")


def _tiny_cfg():
    return reduced(get_arch("granite-8b"), num_layers=1, d_model=32)


@pytest.mark.parametrize("kw", [{}, {"codec": "int8"}, {"codec": "int4"},
                                {"codec": "auto"},
                                {"consensus_dtype": torch.bfloat16}])
def test_energy_estimate_equals_the_reference(kw):
    cfg = _tiny_cfg()
    _, _, E = train.train_federated(cfg, **dict(TINY, rounds=1), **kw)
    jcfg = jreduced(jget_arch("granite-8b"), num_layers=1, d_model=32)
    jp = jax.eval_shape(lambda k: jtransformer.init(k, jcfg),
                        jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(jp)
    per = AGENTS // TASKS
    jep = jenergy.paper_calibrated("fig3")
    codec = kw.get("codec")
    if codec is not None:
        codec = (jcomms.select_codec(jtopo.clusters(TASKS, per), jep)
                 if codec == "auto" else jcomms.resolve_codec(codec))
        bits = 32.0 * sum(x.size for x in leaves)
    else:
        item = 2 if "consensus_dtype" in kw else 4
        bits = float(sum(x.size * item for x in leaves)) * 8
    jep = dataclasses.replace(jep, model_bits=bits, devices_per_cluster=per,
                              B_i=1)
    want = TASKS * jenergy.fl_energy(jep, 1, topology=jtopo.clusters(1, per),
                                     codec=codec)
    assert E == want


def test_prices_four_agent_cluster():
    """The twin of ``tests/test_topology.py::test_train_federated_prices_
    four_agent_cluster``: 12 sidelinks in one 4-agent cluster."""
    cfg = reduced(get_arch("stablelm-3b"), num_layers=1, d_model=32)
    rounds, agents, tasks, local_steps = 1, 4, 1, 1
    stacked, hist, E = train.train_federated(
        cfg, rounds=rounds, agents=agents, tasks=tasks,
        local_steps=local_steps, batch=2, seq=16, lr=1e-3, device="cpu")
    n_bytes = sum(x.numel() // agents * x.element_size()
                  for x in stacked.values())
    ep = dataclasses.replace(
        energy.paper_calibrated("fig3"), model_bits=float(n_bytes) * 8,
        devices_per_cluster=agents // tasks, B_i=local_steps)
    want = tasks * energy.fl_energy(ep, rounds,
                                    topology=topology.clusters(1, 4))
    assert np.isclose(E, want)
    assert energy.fl_comm_energy(ep, rounds, topology.clusters(1, 4)) \
        == pytest.approx(3 * energy.fl_comm_energy(ep, rounds))


def _async_run(**kw):
    args = dict(TINY, codec="int8", dropout_p=0.3, dropout_seed=1,
                availability=topology.AgentProcess.bernoulli(0.7, seed=2),
                tau=2, consensus_plan="sparse")
    args.update(kw)
    return train.train_federated(_tiny_cfg(), **args)


def test_chunks_and_telemetry_give_the_same_bits():
    """int8 + error feedback on fading links with sleeping agents: chunk 1,
    chunk 3 and chunk 1 with buffered telemetry give the same params and
    losses; every row's joules equal the host replay of the round's
    delivered wires, and the summed ledger the replay's."""
    p1, h1, E1 = _async_run(chunk=1)
    p3, h3, E3 = _async_run(chunk=3)
    tel = telemetry.Telemetry()
    pt, ht, Et = _async_run(chunk=1, telemetry=tel)
    assert h1 == h3 == ht and E1 == E3 == Et
    for k in p1:
        assert torch.equal(p1[k], p3[k]) and torch.equal(p1[k], pt[k])
    events = tel.events(driver="fl")
    assert [e["round"] for e in events] == [0, 1, 2]
    assert [e["metric"] for e in events] == [np.float32(h) for h in h1]
    per = AGENTS // TASKS
    topo = topology.clusters(TASKS, per)
    n_params = sum(x.numel() for x in p1.values()) // AGENTS
    ep = dataclasses.replace(energy.paper_calibrated("fig3"),
                             model_bits=32.0 * n_params,
                             devices_per_cluster=per, B_i=1)
    keeps = topology.dropout(topo, 0.3, seed=1, rounds=3)
    acts = topology.availability_stream(
        topology.AgentProcess.bernoulli(0.7, seed=2), AGENTS, 3)
    codec = comms.resolve_codec("int8")
    masks = [np.asarray(kt.adjacency) & a[:, None] & a[None, :]
             for kt, a in zip(keeps, acts)]
    for e, m, a in zip(events, masks, acts):
        assert e["joules"] == delivered_comm_joules(topo, [m], ep, codec)
        assert e["n_active"] == int(a.sum())
    assert tel.joules() == sum(delivered_comm_joules(topo, [m], ep, codec)
                               for m in masks)


def test_sleeping_agents_hold_params_and_residuals():
    """One async round through ``fl_round``: agents asleep keep their
    params and error-feedback residuals bit for bit; awake ones move."""
    cfg = _tiny_cfg()
    p = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ConsensusEngine(topology.clusters(TASKS, AGENTS // TASKS),
                          codec="int8", plan="sparse",
                          agents=topology.AgentProcess.bernoulli(0.5, seed=0))
    g = torch.Generator().manual_seed(3)
    stacked = {k: v.expand((AGENTS,) + v.shape) + torch.randn(
        (AGENTS,) + v.shape, generator=g) * 1e-2 for k, v in p.items()}
    state = {k: torch.randn(v.shape, generator=g) * 1e-3
             for k, v in stacked.items()}
    act = torch.tensor([True, False, True, False])
    ar = eng.async_round(0, eng.init_async_state(device="cpu").age, act=act)
    toks, labels = (torch.from_numpy(a) for a in
                    _tokens(cfg, (AGENTS, 1, 1, 8), seed=9))
    # a copy: the round writes the local steps into the population
    before, st_before = {k: v.clone() for k, v in stacked.items()}, \
        dict(state)
    out, st = train.fl_round(
        eng, lambda q, t, lab: api.lm_loss(q, cfg, t, lab), stacked, state,
        g, toks, labels, lr=0.1, survival=ar.weights, act=ar.act)
    for k in out:
        for a in (1, 3):
            assert torch.equal(out[k][a], before[k][a])
            assert torch.equal(st[k][a], st_before[k][a])
        assert not torch.equal(out[k][0], before[k][0])


def test_auto_plan_is_dense_at_two_clusters_of_two():
    """K·H = 4 is under the port's SPARSE_GATHER_FLOOR (24): ``auto``
    keeps the smoke's configuration dense (the smoke passes "sparse")."""
    topo = topology.clusters(2, 2)
    for codec in (None, "int8", "bf16"):
        assert ConsensusEngine(topo, codec=codec).plan.kind == "dense"
    assert ConsensusEngine(topo, plan="sparse").plan.kind == "sparse"


# ---------------------------------------------------------------------------
# data and codec selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,tasks", [(512, 3), (16, 2), (49152, 1)])
def test_token_tables_equal_jax(vocab, tasks):
    ours = TaskTokenDistribution(vocab_size=vocab, num_tasks=tasks)
    theirs = JDist(vocab_size=vocab, num_tasks=tasks)
    assert np.array_equal(ours.transitions(), theirs.transitions())
    for t in range(tasks):
        assert np.array_equal(ours.transition(t), theirs.transition(t))


def test_sampler_follows_the_transition_table():
    """The rollouts' empirical transitions of each task against its table:
    a chi-squared statistic over cells expecting >= 5 counts, within 5
    standard deviations of its degrees of freedom (draws from an explicit
    generator, so they differ from jax.random's)."""
    dist = TaskTokenDistribution(vocab_size=16, num_tasks=2)
    g = torch.Generator().manual_seed(0)
    toks, labels = dist.sample_traced(g, torch.tensor([0, 1]), 64, 400)
    assert toks.shape == labels.shape == (2, 64, 400)
    assert torch.equal(toks[..., 1:], labels[..., :-1])
    for t in range(2):
        P = dist.transition(t)
        V = P.shape[0]
        C = np.zeros((V, V))
        np.add.at(C, (toks[t].numpy().ravel(), labels[t].numpy().ravel()), 1)
        E = C.sum(axis=1, keepdims=True) * P
        cells = E >= 5
        chi2 = float((((C - E) ** 2) / np.where(cells, E, 1))[cells].sum())
        dof = int(cells.sum()) - V
        assert abs(chi2 - dof) <= 5 * np.sqrt(2 * dof), (t, chi2, dof)
    a = dist.sample(torch.Generator().manual_seed(1), 1, 3, 5)
    b = dist.sample_traced(torch.Generator().manual_seed(1),
                           torch.tensor(1), 3, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_batches_yields_the_samplers_draws():
    dist = TaskTokenDistribution(vocab_size=64, num_tasks=2)
    it = batches(dist, 1, 3, 5, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        got, want = next(it), dist.sample(g, 1, 3, 5)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


SELECT_CASES = [
    ("ring(8)", lambda t: t.ring(8), None, {}),
    ("star(8)", lambda t: t.star(8), None, {}),
    ("degraded", lambda t: t.ring(8).with_edge_efficiency(1e5), None, {}),
    ("dict_no_ef", lambda t: t.ring(8), {"SL": 1e6},
     {"error_feedback": False}),
    ("hierarchical", lambda t: t.hierarchical(3, 2), None, {}),
    ("edgeless", lambda t: t.clusters(2, 1), None, {}),
    ("fast_edges", lambda t: t.ring(6).with_edge_efficiency(3e6),
     {"SL": 1e6}, {}),
    ("clusters(2,2)", lambda t: t.clusters(2, 2), None, {}),
    ("fig4", lambda t: t.clusters(2, 2), "fig4", {}),
]


@pytest.mark.parametrize("name,make,quality,kw", SELECT_CASES,
                         ids=[c[0] for c in SELECT_CASES])
def test_select_codec_matches_jax(name, make, quality, kw):
    """The reference's own cases (``tests/test_comms.py``) and the
    trainer's ``clusters(2, 2)``: the same codec and the same
    efficiencies."""
    jq = quality
    q = quality
    if quality == "fig4":
        jq, q = (jenergy.paper_calibrated("fig4"),
                 energy.paper_calibrated("fig4"))
    want = jcomms.select_codec(make(jtopo), jq, **kw)
    got = comms.select_codec(make(topology), q, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.name == want.name
    assert comms.link_efficiencies(make(topology), q) \
        == jcomms.link_efficiencies(make(jtopo), jq)


def test_select_codec_refuses_a_dict_missing_a_present_class():
    with pytest.raises(ValueError):
        comms.select_codec(topology.star(8), {"SL": 1e6})
    assert comms.BF16_MIN_BIT_PER_JOULE == jcomms.select.BF16_MIN_BIT_PER_JOULE
    assert comms.INT8_MIN_BIT_PER_JOULE == jcomms.select.INT8_MIN_BIT_PER_JOULE


# ---------------------------------------------------------------------------
# twins of the reference's trainer tests and examples
# ---------------------------------------------------------------------------


def test_federated_lm_trainer_loss_drops():
    """The twin of ``tests/test_system.py::test_federated_lm_trainer_loss_
    drops``."""
    cfg = reduced(get_arch("stablelm-3b"), num_layers=2, d_model=64)
    _, hist, E = train.train_federated(cfg, rounds=12, agents=4, tasks=2,
                                       local_steps=8, batch=4, seq=64,
                                       lr=1e-1, device="cpu")
    assert E > 0
    assert min(hist[-3:]) < np.mean(hist[:2]) - 0.05


def test_federated_bf16_consensus_close_to_f32():
    cfg = reduced(get_arch("stablelm-3b"), num_layers=2, d_model=64)
    kw = dict(rounds=4, agents=2, tasks=1, local_steps=2, batch=2, seq=32,
              lr=1e-3, device="cpu")
    _, h32, _ = train.train_federated(cfg, **kw)
    _, h16, _ = train.train_federated(cfg, consensus_dtype=torch.bfloat16,
                                      **kw)
    assert abs(h16[-1] - h32[-1]) < 0.15


def test_train_standard_loss_drops():
    cfg = reduced(get_arch("deepseek-7b"), num_layers=2, d_model=64)
    seen = []
    _, hist = train.train_standard(
        cfg, steps=8, batch=4, seq=64, lr=3e-3, log_every=100, device="cpu",
        callback=lambda t, p, m: seen.append((t, float(m["grad_norm"]))))
    assert hist[-1] < hist[0]
    assert [t for t, _ in seen] == list(range(8))
    assert all(np.isfinite(g) and g > 0 for _, g in seen)


def test_train_refuses_a_family_it_does_not_train():
    """Every LM family trains; the case study's Q-network is not an LM."""
    with pytest.raises(ValueError, match="LM families"):
        train.train_standard(get_arch("paper-dqn"), steps=1, batch=1,
                             seq=4, lr=1e-3, device="cpu")


def test_quickstart_and_federated_lm_twins_run_on_the_cpu():
    res = quickstart.run(t0=2, rounds=2, device="cpu")
    assert len(res["meta_history"]) == 2
    assert all(np.isfinite(res["from_meta"] + res["from_rand"]))
    assert res["E_ML"] > 0 and res["E_FL"] > 0
    out = federated_lm.run(rounds=2, local_steps=1, device="cpu")
    (h32, E32), (h16, E16) = out["f32"], out["bf16"]
    assert len(h32) == len(h16) == 2 and np.all(np.isfinite(h32 + h16))
    assert E16 < E32                     # half the sidelink bytes
