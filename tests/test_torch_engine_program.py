"""``ConsensusEngine.scan_rounds`` as a round program, and the public names
the port adds beside it, against the JAX package on the CPU.

* ``scan_rounds`` against the JAX package's ``scan_rounds`` on the same
  numpy-made params, K = 16 small_world(k=4): dense and sparse plans,
  static / links fading (p = 0.3) / agents asleep (p_active 0.7, τ = 2,
  λ = 0.9), codecs None and int8, telemetry off / buffered / streaming.
  Params and EF residuals are held to 1e-5 plus 4 f32 ulps of the leaf's
  largest value (``tests/test_torch_dynamic.py``'s gate); every row's
  integer fields and the float64 joules priced from them are ``==``, the
  disagreement within rel 1e-5 (with the int8 wire on the first round
  only, as ``tests/test_torch_telemetry.py`` holds it).
* The engine holds one program per argument signature and reuses it; on
  the CPU it runs eagerly, counted, and says why; it never touches the
  drivers' program cache, whose ``cache_stats()`` stay the JAX package's;
  streaming programs are built per call; the byte rule applies; the
  programs die with their engine.
* ``Codec.encode`` / ``decode`` / ``bits`` and ``Wire`` against the JAX
  package's tree API: round trips and bits ``==`` for none / bf16 / int8
  / int4 / int8:b64 / topk, scales per leaf ``==``, stochastic rounding
  held to floor-or-ceil and to its mean.
* ``rl.dqn.DQNState`` / ``init`` / ``collect_experience`` /
  ``experience_batches`` and ``rl.casestudy.behaviour_rollout`` /
  ``sample_td_batches``: the JAX package's shapes (``jax.eval_shape``),
  every transition the reference ``gridworld.step`` of its state and
  action, ε = 1 actions uniform; ``MASKABLE_PLANS``.

On the card the captured programs are held to ``scanloop.uncaptured()``
in ``tests/test_torch_capture.py`` (marked ``gpu``)."""
import dataclasses
import weakref

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comms as jcomms  # noqa: E402
from repro import telemetry as jtl  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import engine as jengine_mod  # noqa: E402
from repro.core import scanloop as jscan  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.models import dqn as jqmodel  # noqa: E402
from repro.rl import casestudy as jcs  # noqa: E402
from repro.rl import dqn as jdqn  # noqa: E402
from repro.rl import gridworld as jgw  # noqa: E402
from repro_torch import telemetry as tl  # noqa: E402
from repro_torch.comms import codecs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import scanloop, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.rl import casestudy, dqn  # noqa: E402

K = 16
PLANS = {"dense": "dense-xla", "sparse": "sparse-pallas"}
F32_ULP = np.finfo(np.float32).eps
EXACT = ("round", "live", "reached", "metric", "n_sl", "n_ul", "n_dl",
         "edges", "n_active", "max_age", "agent_sl", "agent_ul", "agent_dl",
         "wire_bits", "joules", "agent_joules")


def _params(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, 40)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def _t(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}


def _np(p):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in p.items()}


def _close(ours, theirs, like):
    ours, theirs = _np(ours), _np(theirs)
    assert set(ours) == set(theirs)
    for k in ours:
        atol = 1e-5 + 4 * F32_ULP * float(np.abs(like[k]).max())
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=atol,
                                   err_msg=k)


def _process(mod, name):
    if name == "fading":
        return dict(graph=mod.GraphProcess.dropout(0.3, seed=1))
    if name == "async":
        return dict(agents=mod.AgentProcess.bernoulli(0.7, seed=2), tau=2,
                    staleness_decay=0.9)
    return {}


def _engines(plan, codec, process):
    eng = ConsensusEngine(topology.small_world(K, k=4, seed=1), codec=codec,
                          plan=plan, **_process(topology, process))
    jeng = jengine_mod.ConsensusEngine(
        jtopo.small_world(K, k=4, seed=1), codec=codec, plan=PLANS[plan],
        **_process(jtopo, process))
    return eng, jeng


@pytest.mark.parametrize("mode", ["off", "buffered", "streaming"])
@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("process", ["static", "fading", "async"])
@pytest.mark.parametrize("plan", ["dense", "sparse"])
def test_scan_rounds_program_matches_jax(plan, process, codec, mode):
    eng, jeng = _engines(plan, codec, process)
    tel = None if mode == "off" else tl.Telemetry(
        mode=mode, sinks=(tl.MemorySink(),))
    jtel = None if mode == "off" else jtl.Telemetry(mode=mode)
    p = _params()
    out, st = eng.scan_rounds(_t(p), rounds=3, t0=2, telemetry=tel)
    jout, jst = jeng.scan_rounds({k: jnp.asarray(v) for k, v in p.items()},
                                 rounds=3, t0=2, telemetry=jtel)
    _close(out, jout, p)
    if codec is not None:
        _close(st, jst, p)
    (rec,) = eng.program_records() or [None]
    if mode == "streaming":
        assert rec is None                   # built per call, not held
        assert [e["round"] for e in tel.sinks[0].events] == [2, 3, 4]
    else:
        assert (rec.name, rec.why_uncaptured, rec.eager_calls) == (
            "scan_rounds", "cpu", 3)
        assert rec.async_argnums == ((0,) if process == "async" else ())
    if tel is None:
        return
    ev, jev = tel.events(), jtel.events()
    assert [e["round"] for e in ev] == [2, 3, 4] and len(jev) == 3
    for i, (e, je) in enumerate(zip(ev, jev)):
        for f in EXACT:
            assert e[f] == je[f], (f, i)
        if codec is None or i == 0:
            np.testing.assert_allclose(e["disagreement"], je["disagreement"],
                                       rtol=1e-5, err_msg=f"round {i}")
    assert tel.joules(driver="consensus") == jtel.joules(driver="consensus")


def test_scan_rounds_holds_one_program_per_signature():
    """One program per (params, codec state, telemetry, generator)
    signature, reused by a second call: eager on the CPU, counted, says
    why; the drivers' program cache untouched (``cache_stats()`` the JAX
    package's after the same calls, which never reach its cache)."""
    for mod in (jscan, scanloop):
        mod.clear_program_cache()
        mod.reset_cache_stats()
    eng, jeng = _engines("sparse", "int8", "fading")
    p = _params()
    for rounds, g, tel in ((3, 1, False), (3, 2, False), (2, None, False),
                           (2, None, True), (4, None, True)):
        gen = None if g is None else torch.Generator().manual_seed(g)
        eng.scan_rounds(_t(p), generator=gen, rounds=rounds,
                        telemetry=tl.Telemetry() if tel else None)
        jeng.scan_rounds({k: jnp.asarray(v) for k, v in p.items()},
                         rounds=rounds,
                         telemetry=jtl.Telemetry() if tel else None)
    eng.scan_rounds(_t(p), rounds=2,
                    telemetry=tl.Telemetry(mode="streaming"))
    recs = eng.program_records()
    assert [r.eager_calls for r in recs] == [6, 2, 6]
    assert all(r.why_uncaptured == "cpu" and not r.captured
               and r.cache_key[0] == "scan_rounds" and r.async_argnums == ()
               for r in recs)
    assert len({r.cache_key for r in recs}) == 3
    stats, want = scanloop.cache_stats(), jscan.cache_stats()
    keys = ("hits", "misses", "inserts", "evictions", "size", "trace_counts")
    assert {k: stats[k] for k in keys} == {k: want[k] for k in keys}
    assert stats["trace_counts"] == {} and stats["scan_rounds_held_bytes"] == 0


def test_scan_rounds_program_dies_with_its_engine():
    """The program holds a weak proxy of its engine, so dropping the
    engine frees its programs at once, with no garbage collection."""
    eng, _ = _engines("sparse", "int8", "async")
    eng.scan_rounds(_t(_params()), rounds=2)
    (prog,) = eng._round_programs.values()
    ref = weakref.ref(prog)
    del prog, eng
    assert ref() is None


def test_scan_rounds_obeys_the_byte_rule():
    """Under a cap below the program's carry the engine's program is
    eager under the byte rule from its first call, with the same bits."""
    eng, _ = _engines("sparse", "int8", "fading")
    p = _t(_params())
    want = eng.scan_rounds(p, rounds=3)
    cap = scanloop.PROGRAM_CACHE_BYTES
    try:
        scanloop.PROGRAM_CACHE_BYTES = 1
        eng2, _ = _engines("sparse", "int8", "fading")
        got = eng2.scan_rounds(p, rounds=3)
        (rec,) = eng2.program_records()
        assert rec.why_uncaptured == scanloop.OVER_BYTE_CAP
        # params, EF residuals and the round's lane survival, at least
        assert rec.over_cap_bytes >= 2 * 4 * K * 47
        assert scanloop.cache_stats()["eager_by_byte_rule"] >= 1
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
    for a, b in zip(want, got):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_program_audit_covers_the_engines_programs():
    """The programs layer drives ``scan_rounds`` too: its held programs
    are in the registry it audits (none streaming, the async one's
    AsyncState donated), and a held streaming or undonated one is
    JX4 / JX5."""
    from repro_torch.analysis import programs
    engines = programs._tiny_drivers("cpu")
    held = [r for e in engines for r in e.program_records()]
    assert len(held) == 4 and all(r in scanloop.registered_programs()
                                  for r in held)
    assert programs.audit_programs(held) == []
    assert sorted(r.async_argnums for r in held) == [(), (), (0,), (0,)]
    bad = dataclasses.replace(held[-1], streaming=True, donate_argnums=())
    found = programs.audit_programs([bad])
    assert sorted(f.rule for f in found) == ["JX4", "JX5"]
    assert "held by its engine" in found[0].message


def test_maskable_plans():
    assert engine_mod.MASKABLE_PLANS == engine_mod.PLAN_KINDS
    assert tuple(engine_mod.PLAN_ALIASES.get(k, k)
                 for k in jengine_mod.MASKABLE_PLANS) == \
        engine_mod.MASKABLE_PLANS


# -- the codecs' tree API -------------------------------------------------------

SPECS = ("none", "bf16", "int8", "int4", "int8:b64", "int4:b64", "topk:0.1",
         "topk:4")


def _tree():
    """Keys in sorted order: JAX flattens a dict by sorted key, PyTorch's
    pytree by insertion, so the leaves then line up."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((10, 15)).astype(np.float32)
    return {"b": (3.0 * rng.standard_normal((9,))).astype(np.float32),
            "w": w}


@pytest.mark.parametrize("spec", SPECS)
def test_tree_codec_matches_jax(spec):
    c, jc = codecs.get_codec(spec), jcomms.get_codec(spec)
    tree = _tree()
    wire = c.encode(_t(tree))
    jwire = jc.encode({k: jnp.asarray(v) for k, v in tree.items()})
    assert isinstance(wire, codecs.Wire) and wire.codec == jwire.codec
    assert len(wire.payloads) == len(jwire.payloads)
    assert [(m.shape, str(m.dtype).split(".")[-1]) for m in wire.leaves_meta] \
        == [(tuple(m.shape), str(m.dtype)) for m in jwire.leaves_meta]
    assert c.bits(wire) == jc.bits(jwire) == c.model_bits(_t(tree))
    out, jout = c.decode(wire), jc.decode(jwire)
    for k in tree:
        assert out[k].dtype == torch.float32 and out[k].shape == tree[k].shape
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    if "scale" in jwire.payloads[0]:
        for p, jp in zip(wire.payloads, jwire.payloads):
            np.testing.assert_array_equal(p["scale"].numpy(),
                                          np.asarray(jp["scale"]))
    name, payloads = wire                       # tuple-unpacking style
    assert name == spec and payloads is wire.payloads
    ef = codecs.get_codec(spec + "+ef") if spec != "none" else c
    assert ef.bits(ef.encode(_t(tree))) == c.bits(wire)


@pytest.mark.parametrize("spec", ["int8", "int4", "int8:b64"])
def test_tree_codec_stochastic_rounding(spec):
    """With a generator each value rounds to the floor or the ceiling of
    its quantization step, and the decoded mean over many encodes lies
    far within one step of the value."""
    c = codecs.get_codec(spec)
    x = {"w": torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (4, 20)).astype(np.float32))}
    det = c.encode(x)
    scale = det.payloads[0]["scale"]
    step = (scale if scale.ndim == 0 else scale.repeat_interleave(64)[:80]
            .reshape(4, 20))
    y = x["w"] / step
    g = torch.Generator().manual_seed(0)
    acc = torch.zeros_like(x["w"])
    reps = 300
    for _ in range(reps):
        out = c.decode(c.encode(x, generator=g))["w"]
        q = torch.round(out / step)
        assert bool(((q == torch.floor(y)) | (q == torch.ceil(y))).all())
        acc += out
    assert float((acc / reps - x["w"]).abs().max()) < 0.2 * float(step.max())


# -- the RL data helpers ----------------------------------------------------------

def _cfgs():
    cfg = dataclasses.replace(get_arch("paper-dqn"), d_model=16, num_layers=2)
    jcfg = dataclasses.replace(jget_arch("paper-dqn"), d_model=16,
                               num_layers=2)
    return cfg, jcfg


def _shapes(tree, prefix=""):
    """{name: shape}; nested dicts (the JAX package's layer dicts) by
    dotted name, as the port names its flat leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _positions(states):
    cell = np.asarray(states).argmax(-1)
    return np.stack([cell // jgw.GRID_H, cell % jgw.GRID_H], -1)


def _check_transitions(data, task_id):
    """Every transition's reward and next state are the reference
    gridworld's step of its state and action."""
    pos = _positions(data["state"].numpy())
    new, r = jax.vmap(lambda p, a: jgw.step(p, a, task_id))(
        jnp.asarray(pos, jnp.int32),
        jnp.asarray(data["action"].numpy(), jnp.int32))
    np.testing.assert_array_equal(_positions(data["next_state"].numpy()),
                                  np.asarray(new))
    np.testing.assert_array_equal(data["reward"].numpy(), np.asarray(r))
    assert bool((data["state"].sum(-1) == 1).all())


def test_dqn_init_collect_and_batches_match_jax():
    cfg, jcfg = _cfgs()
    st = dqn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert isinstance(st, dqn.DQNState)
    assert set(st.params) == set(st.target_params)
    assert all(torch.equal(st.params[k], st.target_params[k])
               and st.params[k] is not st.target_params[k] for k in st.params)
    jp = jqmodel.init(jax.random.PRNGKey(0), jcfg)
    assert _shapes(st.params) == _shapes(jp)
    g = torch.Generator().manual_seed(1)
    data = dqn.collect_experience(g, st.params, cfg, 3, steps=20, batch=3)
    want = jax.eval_shape(lambda k: jdqn.collect_experience(
        k, jp, jcfg, 3, steps=20, batch=3), jax.random.PRNGKey(1))
    assert _shapes(data) == _shapes(want)
    _check_transitions(data, 3)
    b = dqn.experience_batches(g, st.params, cfg, 2, 3, batch_size=8,
                               target_params=st.target_params)
    jb = jax.eval_shape(lambda k: jdqn.experience_batches(
        k, jp, jcfg, 2, 3, batch_size=8, target_params=jp),
        jax.random.PRNGKey(2))
    assert _shapes(b) == _shapes(jb)       # target_params included
    tp = b.pop("target_params")
    assert all(torch.equal(tp[k][i], st.target_params[k])
               for k in tp for i in range(3))
    _check_transitions({k: v.reshape((-1,) + v.shape[2:])
                        for k, v in b.items()}, 2)


def test_behaviour_rollout_and_td_batches_match_jax():
    g = torch.Generator().manual_seed(4)
    data = casestudy.behaviour_rollout(g, 1, steps=20, batch=8,
                                       device="cpu")
    want = jax.eval_shape(lambda k: jcs.behaviour_rollout(
        k, 1, steps=20, batch=8), jax.random.PRNGKey(0))
    assert _shapes(data) == _shapes(want)
    _check_transitions(data, 1)
    # step-major, as the reference's scan: the first batch rows all start
    # at the entry point
    first = _positions(data["state"][:8].numpy())
    assert (first == np.asarray(jgw.ENTRY)).all()
    b = casestudy.sample_td_batches(g, 4, 5, batch_size=16, episodes=6,
                                    device="cpu")
    jb = jax.eval_shape(lambda k: jcs.sample_td_batches(
        k, 4, 5, batch_size=16, episodes=6), jax.random.PRNGKey(1))
    assert _shapes(b) == _shapes(jb)
    _check_transitions({k: v.reshape((-1,) + v.shape[2:])
                        for k, v in b.items()}, 4)
    # ε = 1: the actions are uniform over the four moves (chi-square, 3
    # degrees of freedom, far beyond its 0.999 quantile of 16.27)
    many = casestudy.behaviour_rollout(torch.Generator().manual_seed(5), 0,
                                       steps=50, batch=80, device="cpu")
    counts = np.bincount(many["action"].numpy(), minlength=4)
    expected = counts.sum() / 4
    assert ((counts - expected) ** 2 / expected).sum() < 16.27
