"""The port's program layer (``repro_torch.core.scanloop``) against the JAX
package's ``repro.core.scanloop``, on the CPU, where a program runs its
round eagerly but is keyed, cached and counted as on the card.

* one sequence of driver calls — ``run_fl_until_scan`` three times with
  one configuration, then a changed ``lr``, a changed leaf shape,
  buffered telemetry, streaming telemetry and an impure sampler, then
  ``maml_train_scan`` three times, all at one chunk size — leaves the
  same hits, misses, inserts, evictions and trace counts in both
  packages' ``cache_stats()``;
* ``traceable`` gives the JAX package's verdict on twin functions: a pure
  device sampler, ``int(t)`` round logic, a numpy host RNG,
  ``next(iterator)`` and a constant output;
* the LRU evicts at ``PROGRAM_CACHE_SIZE`` as the JAX package's does;
* ``own`` leaves the caller's params valid across two driver calls;
* ``Telemetry.report()`` has a ``program_cache`` section, and
  ``trace_signature`` the JAX package's fields.

Captured against ``uncaptured()`` on the card: ``tests/test_torch_capture.py``
(marked ``gpu``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtl  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import maml as jmaml  # noqa: E402
from repro.core import scanloop as jscan  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch import telemetry as tl  # noqa: E402
from repro_torch.core import federated, maml, scanloop, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402

K, D = 4, 6
RNG = np.random.default_rng(5)
XNP = RNG.standard_normal((K, 1, 3, D)).astype(np.float32)
TABLE = np.arange(5, dtype=np.float32)
STATS = ("hits", "misses", "inserts", "evictions", "trace_counts")


def _loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["x"].sum(-1, keepdims=True))
            ** 2).mean()


def _target(sp):
    m = (sp["w"] ** 2).mean()
    return m < -1e9, m


def _jsample(key, _t):
    return {"x": jax.random.normal(key, (K, 1, 3, D))}


def _tsample(generator, _t):
    return {"x": torch.randn((K, 1, 3, D), generator=generator)}


def _jimpure(_key, _t):
    return {"x": jnp.asarray(XNP)}


def _timpure(_generator, _t):
    return {"x": torch.from_numpy(XNP)}


def _params(bias=1):
    w = RNG.standard_normal((K, D, 1)).astype(np.float32) * 0.1
    return {"w": w, "b": np.zeros((K, bias), np.float32)}


def _mloss(p, b):
    return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()


def _jtasks(key, _t):
    k1, k2 = jax.random.split(key)
    x, q = jax.random.normal(k1, (2, 4, D)), jax.random.normal(k2, (2, 4, D))
    return ({"x": x, "y": x.sum(-1, keepdims=True)},
            {"x": q, "y": q.sum(-1, keepdims=True)})


def _ttasks(generator, _t):
    x = torch.randn((2, 4, D), generator=generator)
    q = torch.randn((2, 4, D), generator=generator)
    return ({"x": x, "y": x.sum(-1, keepdim=True)},
            {"x": q, "y": q.sum(-1, keepdim=True)})


def _sequence_jax():
    eng = JEngine(jtopo.ring(K))
    p, p_wide = _params(), _params(2)

    def fl(params, sampler=_jsample, lr=0.1, telemetry=None):
        jfed.run_fl_until_scan(
            _loss, jax.tree.map(jnp.asarray, params), sampler, eng, lr,
            target_fn=_target, max_rounds=2, key=jax.random.PRNGKey(0),
            chunk=2, telemetry=telemetry)

    for _ in range(3):
        fl(p)
    fl(p, lr=0.2)
    fl(p_wide)
    fl(p, telemetry=jtl.Telemetry())
    fl(p, telemetry=jtl.Telemetry(mode="streaming"))
    fl(p, sampler=_jimpure)
    mp = {"w": jnp.zeros((D, 1))}
    for _ in range(3):
        jmaml.maml_train_scan(_mloss, mp, _jtasks, rounds=2, inner_lr=0.1,
                              outer_lr=0.1, chunk=2,
                              key=jax.random.PRNGKey(1))


def _sequence_torch():
    eng = ConsensusEngine(topology.ring(K))
    p, p_wide = _params(), _params(2)

    def fl(params, sampler=_tsample, lr=0.1, telemetry=None):
        federated.run_fl_until_scan(
            _loss, {k: torch.from_numpy(v) for k, v in params.items()},
            sampler, eng, lr, target_fn=_target, max_rounds=2,
            generator=torch.Generator().manual_seed(0), chunk=2,
            telemetry=telemetry)

    for _ in range(3):
        fl(p)
    fl(p, lr=0.2)
    fl(p_wide)
    fl(p, telemetry=tl.Telemetry())
    fl(p, telemetry=tl.Telemetry(mode="streaming"))
    fl(p, sampler=_timpure)
    mp = {"w": torch.zeros((D, 1))}
    for _ in range(3):
        maml.maml_train_scan(_mloss, mp, _ttasks, rounds=2, inner_lr=0.1,
                             outer_lr=0.1, chunk=2,
                             generator=torch.Generator().manual_seed(1))


def test_cache_stats_match_the_jax_package():
    """The satellite's sequence, one chunk size throughout (the JAX
    package traces one program per ``ts`` length, the port builds one
    round whatever the chunk): every counter equal."""
    for mod in (jscan, scanloop):
        mod.clear_program_cache()
        mod.reset_cache_stats()
    _sequence_jax()
    _sequence_torch()
    want, got = jscan.cache_stats(), scanloop.cache_stats()
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}
    assert got["trace_counts"] == {"fl_chunk": 6, "maml_chunk": 1}
    assert got["size"] == want["size"] == 5
    assert got["capacity"] == want["capacity"]


def _twins():
    it_j = iter([jnp.ones(3)] * 4)
    it_t = iter([torch.ones(3)] * 4)
    return {
        "pure device sampler": (
            lambda key, t: jax.random.normal(key, (3,)) + t,
            lambda g, t: torch.randn(3, generator=g) + t),
        "int(t) round logic": (
            lambda key, t: jnp.full((3,), TABLE[int(t)]),
            lambda g, t: torch.full((3,), float(TABLE[int(t)]))),
        "numpy host RNG": (
            lambda key, t: jnp.asarray(
                np.random.default_rng(0).standard_normal(3)),
            lambda g, t: torch.as_tensor(
                np.random.default_rng(0).standard_normal(3))),
        "next(iterator)": (lambda key, t: next(it_j),
                           lambda g, t: next(it_t)),
        "constant output": (lambda key, t: jnp.zeros(3),
                            lambda g, t: torch.zeros(3)),
    }


@pytest.mark.parametrize("name", list(_twins()))
def test_traceable_gives_the_jax_verdict(name):
    jfn, tfn = _twins()[name]
    _, want = jscan.traceable(jfn, jax.random.PRNGKey(0), jnp.int32(0))
    g = torch.Generator().manual_seed(0)
    before = g.get_state().clone()
    _, got = scanloop.traceable(tfn, g, torch.zeros((), dtype=torch.int64))
    assert got == want == (name == "pure device sampler")
    assert torch.equal(g.get_state(), before)     # the probe draws nothing


def test_traceable_follows_generator_draws_and_transforms():
    """A sampler that only draws from the generator depends on it; one
    drawing from its own generator does not; vmapped gradients keep the
    dependence; a host read of the round fails."""
    g, t = torch.Generator().manual_seed(0), torch.zeros((), dtype=torch.int64)
    own_gen = torch.Generator().manual_seed(1)
    verdicts = {
        "generator only": lambda g, t: torch.randint(0, 5, (2,), generator=g),
        "private generator": lambda g, t: torch.randint(
            0, 5, (2,), generator=own_gen),
        "vmapped grad": lambda g, t: torch.func.vmap(torch.func.grad(
            lambda x: (x * x).sum()))(torch.randn(2, 3, generator=g)),
        ".item()": lambda g, t: torch.ones(3) * t.item(),
    }
    got = {k: scanloop.traceable(f, g, t)[1] for k, f in verdicts.items()}
    assert got == {"generator only": True, "private generator": False,
                   "vmapped grad": True, ".item()": False}


def test_lru_evicts_at_capacity_as_the_jax_package():
    for mod in (jscan, scanloop):
        mod.clear_program_cache()
        mod.reset_cache_stats()
        n = mod.PROGRAM_CACHE_SIZE
        for i in range(n + 3):
            mod.cached_program(("k", i), lambda: object())
        assert mod.get_cached_program(("k", 0)) is None
        assert mod.get_cached_program(("k", n + 2)) is not None
        mod.cached_program(("k", 3), lambda: object())   # a hit: LRU bump
    assert scanloop.PROGRAM_CACHE_SIZE == jscan.PROGRAM_CACHE_SIZE == 32
    want, got = jscan.cache_stats(), scanloop.cache_stats()
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}
    assert got["evictions"] == 3 and got["size"] == 32
    scanloop.clear_program_cache()


def test_byte_cap_evicts_oversized_programs_first_then_lru():
    """:func:`scanloop.trim_program_cache` against the device bytes the
    cached programs hold (measured at capture on the card, set by hand
    here): a program above the cap on its own falls under the byte rule
    first (eager for good, its graph freed, its entry kept, no eviction),
    then the least recently used go until the rest fit; ``None`` lifts
    the cap."""
    scanloop.clear_program_cache()
    scanloop.reset_cache_stats()
    cap = scanloop.PROGRAM_CACHE_BYTES
    progs = {}
    try:
        scanloop.PROGRAM_CACHE_BYTES = 100
        for name, held in (("a", 40), ("b", 40), ("c", 0)):
            progs[name] = scanloop.cached_program(
                ("bytes", name), lambda: scanloop.donating_graph(
                    lambda c: ((c,), c), donate_argnums=(0,)))
            progs[name].record.held_bytes = held
        progs["c"].record.held_bytes = 150       # c's capture was measured
        scanloop.trim_program_cache()
        assert list(scanloop._program_cache) == [("bytes", "a"),
                                                 ("bytes", "b"),
                                                 ("bytes", "c")]
        rec = progs["c"].record
        assert (rec.why_uncaptured, rec.over_cap_bytes, rec.held_bytes) == (
            scanloop.OVER_BYTE_CAP, 150, 0)
        assert scanloop.cache_stats()["evictions"] == 0
        (out,), _ = progs["c"](torch.ones(2))     # eager from now on
        assert torch.equal(out, torch.ones(2)) and rec.eager_calls == 1
        progs["a"].record.held_bytes = 70        # a, the LRU, goes next
        scanloop.trim_program_cache()
        assert list(scanloop._program_cache) == [("bytes", "b"),
                                                 ("bytes", "c")]
        stats = scanloop.cache_stats()
        assert (stats["evictions"], stats["held_bytes"],
                stats["byte_capacity"]) == (1, 40, 100)
        assert stats["eager_by_byte_rule"] >= 1
        scanloop.PROGRAM_CACHE_BYTES = None
        progs["b"].record.held_bytes = 10 ** 12
        scanloop.trim_program_cache()
        assert scanloop.cache_stats()["size"] == 2
        assert progs["b"].record.why_uncaptured is None
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
        scanloop.clear_program_cache()


def test_held_bytes_lower_bound_counts_carry_once_and_clones():
    """The byte rule's prediction from shapes alone, against hand counts:
    the donated carry once per tensor (a leaf passed twice is one
    buffer), every other tensor argument cloned, non-tensors free."""
    meta = dict(device="meta")
    w = torch.empty((256, 1000), **meta)                      # 1,024,000 B
    st = {"w": torch.empty((256, 1000), dtype=torch.float32, **meta)}
    clock = torch.empty((256,), dtype=torch.int32, **meta)    # 1,024 B
    link = torch.empty((256, 4), dtype=torch.bool, **meta)    # 1,024 B
    t = torch.empty((), dtype=torch.int64, **meta)            # 8 B
    carry = ({"w": w}, st, clock, None)
    xs = {"t": t, "link": link, "act": None}
    got = scanloop.held_bytes_lower_bound((carry, xs, "eval"), (0,))
    assert got == 1_024_000 * 2 + 1_024 + 1_024 + 8
    assert scanloop.held_bytes_lower_bound(((w, w), xs), (0,)) == \
        1_024_000 + 1_024 + 8
    # not donated: each leaf is cloned into its own static input
    assert scanloop.held_bytes_lower_bound(((w, w), xs), ()) == \
        2 * 1_024_000 + 1_024 + 8
    half = torch.empty((4, 3), dtype=torch.bfloat16, **meta)
    assert scanloop.held_bytes_lower_bound((half, 1.5, None), (0,)) == 24


def _two_fl_calls(mod, make_params, sample, gen, **kw):
    eng = kw.pop("engine")
    outs = []
    for _ in range(2):
        outs.append(mod.run_fl_until_scan(
            _loss, make_params(), sample, eng, 0.1, target_fn=_target,
            max_rounds=3, chunk=2, **gen(), **kw))
    return outs


def test_program_above_the_byte_cap_stays_cached_and_eager():
    """F4 on the CPU: under ``PROGRAM_CACHE_BYTES = 1`` every program is
    above the cap from its shapes alone. Two ``run_fl_until_scan`` calls
    leave the JAX package's hits, misses and inserts (its cache has no
    byte cap and hits at any size); the second call builds nothing, the
    program stays cached under the byte rule and both calls give the same
    bits."""
    for mod in (jscan, scanloop):
        mod.clear_program_cache()
        mod.reset_cache_stats()
    p = _params()
    _two_fl_calls(jfed, lambda: jax.tree.map(jnp.asarray, p), _jsample,
                  lambda: {"key": jax.random.PRNGKey(0)},
                  engine=JEngine(jtopo.ring(K), codec="int8"))
    cap = scanloop.PROGRAM_CACHE_BYTES
    try:
        scanloop.PROGRAM_CACHE_BYTES = 1
        eng = ConsensusEngine(topology.ring(K), codec="int8")
        outs = []
        for i in range(2):
            before = dict(scanloop.TRACE_COUNTS)
            outs.append(federated.run_fl_until_scan(
                _loss, {k: torch.from_numpy(v) for k, v in p.items()},
                _tsample, eng, 0.1, target_fn=_target, max_rounds=3,
                chunk=2, generator=torch.Generator().manual_seed(0),
                return_state=True))
            if i == 1:
                assert dict(scanloop.TRACE_COUNTS) == before
        want, got = jscan.cache_stats(), scanloop.cache_stats()
        assert {k: got[k] for k in ("hits", "misses", "inserts",
                                    "evictions")} == \
            {k: want[k] for k in ("hits", "misses", "inserts", "evictions")}
        assert (got["hits"], got["size"], got["eager_by_byte_rule"]) == \
            (1, 1, 1)
        (prog,) = scanloop._program_cache.values()
        rec = prog.record
        assert rec.why_uncaptured == scanloop.OVER_BYTE_CAP
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        ef = {k: torch.zeros_like(v) for k, v in tp.items()}
        assert rec.over_cap_bytes >= scanloop.held_bytes_lower_bound(
            ((tp, ef),), (0,)) > 0              # at least params + EF state
        assert rec.captures == 0 and rec.held_bytes == 0
        assert rec.eager_calls == 6            # 3 rounds a call
        assert all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in p)
        assert outs[0][1:3] == outs[1][1:3]
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
        scanloop.clear_program_cache()


def test_own_keeps_the_callers_params_across_driver_calls():
    eng = ConsensusEngine(topology.ring(K), codec="int8")
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    saved = {k: v.clone() for k, v in params.items()}
    outs = [federated.run_fl_until_scan(
        _loss, params, _tsample, eng, 0.1, target_fn=_target, max_rounds=3,
        generator=torch.Generator().manual_seed(0), chunk=2)
        for _ in range(2)]
    assert all(torch.equal(params[k], saved[k]) for k in params)
    assert outs[0][1] == outs[1][1] == 3
    assert all(torch.equal(outs[0][0][k], outs[1][0][k]) for k in params)
    assert not torch.equal(outs[0][0]["w"], saved["w"])
    assert scanloop.own(params) is params          # the CPU donates nothing


def test_program_records_on_the_cpu():
    """A program on the CPU runs its round eagerly, says why, builds one
    variant per argument signature and never captures."""
    prog = scanloop.donating_graph(
        lambda c, x: ((c + x,), c * 2), donate_argnums=(0,), name="toy")
    before = dict(scanloop.TRACE_COUNTS)
    (c,), ys = prog(torch.ones(2), torch.ones(2))
    (c,), ys = prog(c, torch.ones(2))
    assert torch.equal(c, torch.full((2,), 3.0)) and torch.equal(ys, 2 * (c - 1))
    (c,), ys = prog(torch.ones(3), torch.ones(3))
    rec = prog.record
    assert (rec.captured, rec.why_uncaptured, rec.eager_calls,
            rec.replays) == (False, "cpu", 3, 0)
    assert scanloop.TRACE_COUNTS["toy"] - before.get("toy", 0) == 2
    assert rec in scanloop.registered_programs()
    with scanloop.uncaptured():
        with scanloop.uncaptured():
            prog(c, torch.ones(3))
    assert rec.eager_calls == 4 and scanloop._UNCAPTURED[0] == 0


def test_report_has_a_program_cache_section():
    scanloop.clear_program_cache()
    scanloop.reset_cache_stats()
    _sequence_torch()
    rep = tl.Telemetry().report()
    assert rep["program_cache"] == scanloop.cache_stats()
    assert rep["program_cache"]["inserts"] == 5
    # nothing is captured on the CPU, so the cache holds no device bytes
    assert rep["program_cache"]["held_bytes"] == 0
    assert rep["program_cache"]["byte_capacity"] == \
        scanloop.PROGRAM_CACHE_BYTES
    assert tl.Telemetry(mode="streaming").trace_signature() == \
        jtl.Telemetry(mode="streaming").trace_signature()
    assert tl.Telemetry().trace_signature() == \
        jtl.Telemetry().trace_signature()


def test_program_audit_is_clean_and_catches_admitted_host_programs():
    """``--layer programs`` on the CPU finds nothing on the drivers; a
    record admitted with a host function, streaming, a replay that broke
    donation and an undonated AsyncState is JX1 / JX4 / JX3 / JX5."""
    from repro_torch.analysis import programs
    assert programs.run_program_audit("cpu") == []
    bad = scanloop.ProgramRecord("fl_chunk", None, (),
                                 cache_key=("fl_chunk",),
                                 host_fns=("sample_batches",),
                                 streaming=True, captured=True,
                                 in_place=False, async_argnums=(0,))
    rules = sorted(f.rule for f in programs.audit_programs([bad]))
    assert rules == ["JX1", "JX3", "JX4", "JX5"]
    good = dataclasses.replace(bad, donate_argnums=(0,), host_fns=(),
                               streaming=False, in_place=True)
    assert programs.audit_programs([good]) == []


def test_nested_built_programs_blocks_collect_their_own():
    """An inner ``built_programs`` block collects the programs built in
    it, the enclosing block every program of both, whichever list ends
    first equal to the other."""
    with scanloop.built_programs() as outer:
        with scanloop.built_programs() as inner:
            scanloop.donating_graph(lambda c: ((c,), None),
                                    donate_argnums=(0,), name="inner")
        scanloop.donating_graph(lambda c: ((c,), None),
                                donate_argnums=(0,), name="outer")
    assert [r.name for r in inner] == ["inner"]
    assert [r.name for r in outer] == ["inner", "outer"]
