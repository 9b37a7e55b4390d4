"""The LM launchers as programs (``repro_torch.launch.serve`` and
``repro_torch.launch.train``), on the CPU:

* every decoder family decodes the same bits with its position as a 0-d
  int32 tensor on the device (how the captured decode step reads it) as
  with a Python int: prefill + 8 steps, logits, tokens and caches ``==``,
  and within the JAX decode's tolerance at the same inputs (an SWA cache
  wrapping);
* the capture probe (``scanloop.traceable``) passes for the prefill step,
  the decode step, the standard train step and the federated round of
  each family: no host read, outputs that depend on the inputs;
* one variant per program across a whole ``serve`` / ``train_standard`` /
  ``train_federated`` call (records and ``TRACE_COUNTS``);
* a kept argument is read by reference: never cloned, never counted, a
  replay with another object refused;
* launcher programs (built per call) are outside the byte rule, a
  driver's cached program is not;
* the device fills that replaced host copies in the optimizers, the
  schedules and the sampler give the same bits.

The card's side (the same programs captured ``==`` uncaptured) is in
``tests/test_torch_capture.py``."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import federated, scanloop, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.data import TaskTokenDistribution  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models.api import get_model, lm_loss  # noqa: E402
from repro_torch.optim import adam, schedules  # noqa: E402
from test_torch_transformer import SLICE_TOL, _close, _top2_margin  # noqa: E402

#: one reduced arch per decoder family (danube and the hybrid at a window
#: of 64 < the prompt, so their circular caches wrap)
FAMILIES = {"dense": "h2o-danube-3-4b", "moe": "qwen2-moe-a2.7b",
            "vlm": "chameleon-34b", "hybrid": "recurrentgemma-9b",
            "ssm": "xlstm-125m", "encdec": "whisper-large-v3"}
B, PROMPT, GEN = 2, 72, 8
#: the probe's sizes: every family, a few layers, narrow
TINY = dict(d_model=64, vocab=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layers(family):
    return 3 if family == "hybrid" else 2


def _pair(family):
    arch = FAMILIES[family]
    jcfg = jreduced(jget_arch(arch), num_layers=_layers(family))
    cfg = reduced(get_arch(arch), num_layers=_layers(family))
    jp = japi.get_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    model = get_model(cfg).init(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(jp, cfg, device="cpu"))
    return jcfg, cfg, jp, model


def _batch(cfg, rng):
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    out = {"tokens": toks}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return out


def _leaves(tree):
    return torch.utils._pytree.tree_flatten(tree)[0]


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_device_cache_index_decode_equals_int_decode_and_jax(family):
    """Prefill, then 8 decode steps fed the JAX decode's greedy tokens:
    with the position as a 0-d int32 tensor the logits, the tokens and
    every cache are ``==`` those with a Python int, and the logits and the
    final caches lie within the JAX decode's tolerance (the reference's
    ``jnp.int32(prompt_len + i)``); greedy tokens agree where the
    reference's top two differ by more than 1e-3."""
    jcfg, cfg, jp, model = _pair(family)
    jmodel, api = japi.get_model(jcfg), get_model(cfg)
    bd = _batch(cfg, np.random.default_rng(1))
    jc = jmodel.init_cache(jcfg, B, PROMPT + GEN)
    c = api.init_cache(cfg, B, PROMPT + GEN, device="cpu")
    jlast, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, jc, {k: jnp.asarray(v) for k, v in bd.items()})
    last, c = steps.make_prefill_step(cfg)(
        model, c, {k: torch.from_numpy(v) for k, v in bd.items()})
    _close(last, jlast, msg="prefill logits")
    jstep = jax.jit(lambda p, c, t, i: jmodel.forward(
        p, jcfg, t, caches=c, cache_index=i)[:2])
    decode = steps.make_decode_step(cfg)
    tok = np.asarray(jnp.argmax(jlast[:, -1], -1), np.int32)[:, None]
    c_int = c_dev = c
    for i in range(GEN):
        idx = PROMPT + i
        want, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(idx))
        t = torch.tensor(tok)
        pos = torch.tensor(idx, dtype=torch.int32)
        with torch.no_grad():
            got_int, c_int, _ = api.forward(model, cfg, t, caches=c_int,
                                            cache_index=idx)
            got, nc, _ = api.forward(model, cfg, t, caches=c_dev,
                                     cache_index=pos)
        assert torch.equal(got, got_int) and _same(nc, c_int), i
        nxt, c_dev = decode(model, c_dev, {"tokens": t, "cache_index": pos})
        assert _same(c_dev, nc), i
        assert torch.equal(nxt[:, 0], torch.argmax(got[:, -1], -1).to(
            torch.int32)), i
        _close(got, want, msg=f"decode step {i} logits")
        sure = _top2_margin(want[:, -1]) > 1e-3
        jtok = np.asarray(jnp.argmax(want[:, -1], -1), np.int32)
        assert np.array_equal(nxt.numpy()[sure, 0], jtok[sure]), i
        tok = jtok[:, None]
    if cfg.family in ("dense", "moe", "vlm"):
        for i in range(cfg.num_layers):
            for kv in ("k", "v"):
                _close(c_dev[i][kv], jc[kv][i],
                       msg=f"layer {i} cache {kv} after decode")


# -- the capture probe -----------------------------------------------------------

def _tiny(family):
    cfg = reduced(get_arch(FAMILIES[family]), num_layers=_layers(family),
                  **TINY)
    model = get_model(cfg).init(cfg, generator=torch.Generator().manual_seed(
        0), device="cpu")
    return cfg, model


def _prompt(cfg, S=8):
    g = torch.Generator().manual_seed(1)
    bd = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.family == "encdec":
        bd["frames"] = torch.randn(B, cfg.encdec.encoder_seq_len,
                                   cfg.d_model, generator=g)
    return bd


def _fl_round_args(cfg):
    """(round function, its probe arguments): 2 agents of one task,
    int8+ef, links fading and agents asleep, with a telemetry row. The
    dense plan: on the CPU the sparse plan's kernels check their lane
    indices on the host (the card's kernels check them themselves)."""
    from repro_torch import telemetry
    engine = ConsensusEngine(
        topology.clusters(1, 2), codec="int8", plan="dense",
        graph=topology.GraphProcess.dropout(0.3, seed=1),
        agents=topology.AgentProcess.bernoulli(0.7, seed=2), tau=2)
    params = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    stacked = {k: v.expand((2,) + v.shape).clone() for k, v in params.items()}
    dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=1)
    grid = torch.zeros((2, 1), dtype=torch.int64)
    fn = train.federated_round(
        engine, lambda p, t, y: lm_loss(p, cfg, t, y), dist, grid, batch=1,
        seq=8, lr=1e-3, recorder=telemetry.Telemetry().recorder_for(engine))
    ts = torch.arange(0, 1)
    clock, age = engine.init_async_state(device="cpu")
    carry = (stacked, engine.init_state(stacked), clock, age)
    xs = {"t": ts[0], "link": engine.round_survival(ts)[0],
          "act": engine.availability(ts)[0]}
    return fn, (carry, xs, torch.Generator().manual_seed(3))


def _probe_case(family, which):
    cfg, model = _tiny(family)
    api = get_model(cfg)
    if which in ("prefill", "decode"):
        prefill, decode = serve_lib.serving_programs(cfg)
        caches = api.init_cache(cfg, B, 12, device="cpu")
        bd = _prompt(cfg)
        if which == "prefill":
            return prefill.fn, (model, caches, bd)
        (caches,), (_, nxt) = prefill.fn(model, caches, bd)
        return decode.fn, (model, caches, {
            "tokens": nxt, "cache_index": torch.tensor(8, dtype=torch.int32)})
    if which == "train_step":
        prog = train.train_step_program(cfg, lr=1e-3)
        params = api.stack_params(model)
        bd = _prompt(cfg)
        bd["labels"] = bd["tokens"].roll(-1, 1)
        return prog.fn, (params, prog.opt.init(params), bd)
    return _fl_round_args(cfg)


PROBE_CASES = [(f, w) for f in FAMILIES
               for w in ("prefill", "decode", "train_step", "fl_round")
               if (f, w) != ("encdec", "fl_round")]


@pytest.mark.parametrize("family,which", PROBE_CASES)
def test_launcher_functions_pass_the_capture_probe(family, which):
    """Each launcher program's function at a tiny size: no host read of a
    tensor (``.item()``, ``int(t)``, a copy off the device), and outputs
    that depend on its inputs. The encoder-decoder has no federated round
    (ROADMAP C8)."""
    fn, args = _probe_case(family, which)
    _, ok = scanloop.traceable(fn, *args)
    assert ok, (family, which)


def test_int_position_decode_fails_the_probe():
    """The probe's contrast: the same decode step with the position read
    on the host (``int(t)``) fails."""
    fn, (model, caches, bd) = _probe_case("dense", "decode")
    host = dict(bd, cache_index=bd["cache_index"])

    def host_read(m, c, b):
        return fn(m, c, dict(b, cache_index=int(b["cache_index"])))
    assert scanloop.traceable(fn, model, caches, host)[1]
    assert not scanloop.traceable(host_read, model, caches, host)[1]


# -- one variant per program per call ----------------------------------------------

def _run_launchers(cfg, dense):
    """``serve`` (prefill + 4 decode steps), ``train_standard`` (3 steps)
    and ``train_federated`` (3 rounds at chunk 2, async int8+ef on the
    sparse plan, buffered telemetry) at a tiny size, their records
    collected."""
    from repro_torch import telemetry
    with scanloop.built_programs() as records:
        serve_lib.serve(cfg, batch=B, prompt_len=8, gen=5, device="cpu",
                        verbose=False)
        train.train_standard(cfg, steps=3, batch=B, seq=8, lr=1e-3,
                             device="cpu", log_every=100)
        train.train_federated(
            dense, rounds=3, agents=2, tasks=1, local_steps=1, batch=1,
            seq=8, lr=1e-3, consensus_plan="sparse", codec="int8",
            dropout_p=0.3, availability=topology.AgentProcess.bernoulli(
                0.7, seed=1), tau=2, chunk=2,
            telemetry=telemetry.Telemetry(), device="cpu")
    return {r.name: r for r in records}


def test_one_variant_per_program_per_call():
    """Across a whole call each launcher program builds one variant (its
    argument signature never changes: the decode position is a tensor),
    counted once in ``TRACE_COUNTS``; on the CPU every call runs eagerly
    and says why."""
    cfg, _ = _tiny("hybrid")
    dense, _ = _tiny("dense")
    scanloop.reset_cache_stats()
    recs = _run_launchers(cfg, dense)
    calls = {"serve_prefill": 1, "serve_decode": 4, "train_step": 3,
             "train_fl_round": 3}
    assert set(recs) == set(calls)
    assert {n: scanloop.TRACE_COUNTS[n] for n in calls} == \
        dict.fromkeys(calls, 1)
    for name, rec in recs.items():
        assert rec.cache_key is None
        assert (rec.eager_calls, rec.captures, rec.why_uncaptured,
                rec.held_bytes) == (calls[name], 0, "cpu", 0), name
    assert recs["serve_decode"].keep_argnums == (0,)
    assert recs["serve_decode"].donate_argnums == (1,)
    assert recs["train_step"].donate_argnums == (0, 1)
    assert recs["train_fl_round"].async_argnums == (0,)
    scanloop.reset_cache_stats()


def test_serve_reports_its_programs():
    cfg, _ = _tiny("dense")
    res = serve_lib.serve(cfg, batch=B, prompt_len=8, gen=3, device="cpu",
                          verbose=False)
    assert set(res.programs) == {"prefill", "decode"}
    assert res.capture_s == {"prefill": 0.0, "decode": 0.0}
    assert res.programs["decode"].eager_calls == 2
    assert len(res.caches) == cfg.num_layers


# -- kept arguments ----------------------------------------------------------------

def _kept_program():
    def fn(w, c, x):
        return (c + x @ w,), None
    return scanloop.donating_graph(fn, donate_argnums=(1,),
                                   keep_argnums=(0,), name="kept_case")


def test_kept_argument_is_neither_cloned_nor_counted():
    """The static inputs of a capture hold the kept tensor itself (the
    donated one is the carry buffer, the rest are clones counted in the
    program's bytes); the byte rule's prediction counts a kept argument
    as 0; a replay handed another tensor, or the kept module with a
    parameter moved, is refused by name; a kept module's signature is its
    type, so another module is that same variant and refused."""
    prog = _kept_program()
    w, c, x = torch.ones(3, 3), torch.zeros(3), torch.ones(3)
    v = scanloop._Variant("variant 0", [1], [c])
    static = prog._static_inputs(v, [w, c, x], {0})
    assert static[0] is w and static[1] is c
    assert static[2] is not x and torch.equal(static[2], x)
    assert prog._static_bytes == x.numel() * 4
    prog._check_kept(v, [w, c, x])
    with pytest.raises(RuntimeError, match="'kept_case'.*kept argument "
                                           "leaf 0"):
        prog._check_kept(v, [w.clone(), c, x])
    meta = dict(device="meta")
    args = (torch.empty(1000, 1000, **meta), torch.empty(10, **meta),
            torch.empty(10, **meta))
    assert scanloop.held_bytes_lower_bound(args, (1,), (0,)) == 80
    assert scanloop.held_bytes_lower_bound(args, (1,)) == 4_000_080

    lin = torch.nn.Linear(3, 3)
    vm = scanloop._Variant("variant 0", [1], [c])
    prog._static_inputs(vm, [lin, c, x], {0})
    prog._check_kept(vm, [lin, c, x])
    lin.weight.data = lin.weight.data.clone()           # storage moved
    with pytest.raises(RuntimeError, match="kept argument leaf 0"):
        prog._check_kept(vm, [lin, c, x])
    with pytest.raises(RuntimeError, match="kept argument leaf 0"):
        prog._check_kept(vm, [torch.nn.Linear(3, 3), c, x])

    scanloop.reset_cache_stats()
    mod = scanloop.donating_graph(lambda m, c: ((m(c),), None),
                                  donate_argnums=(1,), keep_argnums=(0,),
                                  name="kept_module")
    for m in (torch.nn.Linear(3, 3), torch.nn.Linear(3, 3)):
        mod(m, torch.zeros(3))
    assert scanloop.TRACE_COUNTS["kept_module"] == 1
    scanloop.reset_cache_stats()
    with pytest.raises(ValueError, match="overlap"):
        scanloop.donating_graph(lambda a: ((a,), None), donate_argnums=(0,),
                                keep_argnums=(0,))


# -- the byte rule ---------------------------------------------------------------------

def test_launcher_programs_are_outside_the_byte_rule():
    """At a 1-byte cap the launchers' programs run as they would (eager
    on the CPU, "cpu" their reason) while a driver's cached program falls
    under the byte rule as before; the cache's sweep skips a program built
    per call whose held bytes exceed the cap and ``cache_stats()`` reports
    them under their own field."""
    cfg, _ = _tiny("hybrid")
    dense, _ = _tiny("dense")
    cap = scanloop.PROGRAM_CACHE_BYTES
    scanloop.clear_program_cache()
    try:
        scanloop.PROGRAM_CACHE_BYTES = 1
        recs = _run_launchers(cfg, dense)
        assert all(r.why_uncaptured == "cpu" and r.over_cap_bytes == 0
                   for r in recs.values())
        eng = ConsensusEngine(topology.ring(4), codec="int8")
        with scanloop.built_programs() as drv:
            federated.run_fl_until_scan(
                lambda p, b: ((b["x"] @ p["w"]) ** 2).mean(),
                {"w": torch.ones((4, 3, 1))},
                lambda g, t: {"x": torch.randn((4, 1, 2, 3), generator=g)},
                eng, 0.1, target_fn=lambda sp: (sp["w"].mean() < -1e9,
                                                sp["w"].mean()),
                max_rounds=2, chunk=2,
                generator=torch.Generator().manual_seed(0))
        assert [r.why_uncaptured for r in drv] == [scanloop.OVER_BYTE_CAP]
        per_call = scanloop.donating_graph(lambda a: ((a,), None),
                                           donate_argnums=(0,))
        driver = scanloop.cached_program(
            ("bytes", "driver"), lambda: scanloop.donating_graph(
                lambda a: ((a,), None), donate_argnums=(0,)))
        per_call.record.held_bytes = driver.record.held_bytes = 10
        scanloop.trim_program_cache()
        assert per_call.record.why_uncaptured is None
        assert driver.record.why_uncaptured == scanloop.OVER_BYTE_CAP
        assert scanloop.cache_stats()["per_call_held_bytes"] == 10
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
        scanloop.clear_program_cache()


# -- fills in place of host copies --------------------------------------------------

def test_device_fills_give_the_bits_of_the_host_copies():
    """Adam's bias corrections, the schedules' lr and the sampler's task
    index are fills on the device now; their values are the host copies'
    bit for bit (here both are on the CPU, where a copy is free)."""
    f32 = torch.float32
    for b in (0.9, 0.999, 0.95, 0.98):
        for s in (1, 2, 7, 1000):
            sf = torch.tensor(float(s))
            old = 1 - torch.pow(torch.tensor(b, dtype=f32), sf)
            new = 1 - torch.pow(torch.full((), b, dtype=f32), sf)
            assert torch.equal(old, new)
    # one Adam step: the update against the formula with host copies
    p = {"w": torch.randn(5, generator=torch.Generator().manual_seed(0))}
    g = {"w": torch.randn(5, generator=torch.Generator().manual_seed(1))}
    opt = adam(3e-4)
    st = opt.init(p)
    for _ in range(3):
        upd, st = opt.update(g, st, p)
    sf = st["step"].to(f32)
    m, v = torch.zeros(5), torch.zeros(5)
    for _ in range(3):
        m = 0.9 * m + 0.1 * g["w"]
        v = 0.999 * v + 0.001 * torch.square(g["w"])
    bc1 = 1 - torch.pow(torch.tensor(0.9, dtype=f32), sf)
    bc2 = 1 - torch.pow(torch.tensor(0.999, dtype=f32), sf)
    want = -3e-4 * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
    assert torch.equal(upd["w"], want)

    steps_ = torch.arange(0, 40, dtype=torch.int32)
    old = {
        "constant": lambda s: torch.tensor(0.01, dtype=f32),
        "cosine": lambda s: torch.tensor(0.01, dtype=f32) * (
            0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * torch.clamp(
                s.to(f32) / 30, 0.0, 1.0)))),
    }
    new = {"constant": schedules.constant(0.01),
           "cosine": schedules.cosine_decay(0.01, 30)}
    for k in old:
        for s in steps_:
            assert torch.equal(new[k](s), old[k](s)), (k, int(s))
    warm = schedules.warmup_cosine(0.01, 5, 30)
    cos = schedules.cosine_decay(0.01, 25)
    for s in steps_:
        w = torch.clamp(s.to(f32) / 5, max=1.0)
        want = torch.where(s <= 5, torch.tensor(0.01, dtype=f32) * w,
                           cos(s - 5))
        assert torch.equal(warm(s), want), int(s)

    dist = TaskTokenDistribution(vocab_size=64, num_tasks=3)
    got = dist.sample(torch.Generator().manual_seed(4), 2, 3, 6)
    want = dist._rollout(torch.Generator().manual_seed(4),
                         dist.log_tables("cpu"), torch.tensor(2), 3, 6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_launchers_hand_back_their_results():
    """The programs change no result on the CPU: ``train_standard``'s
    params after 2 steps equal 2 calls of ``make_train_step``'s step on
    the same batches."""
    cfg, _ = _tiny("dense")
    params, hist = train.train_standard(cfg, steps=2, batch=B, seq=8,
                                        lr=1e-3, device="cpu", log_every=100)
    gen = torch.Generator().manual_seed(0)
    p = train.init_params(cfg, gen, "cpu")
    step, opt = steps.make_train_step(cfg, lr=1e-3, clip_norm=1.0)
    st = opt.init(p)
    dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=1)
    want = []
    for _ in range(2):
        toks, labels = dist.sample(gen, 0, B, 8)
        p, st, m = step(p, st, {"tokens": toks, "labels": labels})
        want.append(float(m["loss"]))
    assert hist == want
    assert set(params) == set(p) and all(torch.equal(params[k], p[k])
                                         for k in p)


def test_local_round_writes_the_population_in_place():
    """``local_round`` writes each agent's new params into its row of the
    population it is given (the captured round's donated buffers), the
    same bits as on a broadcast population, which it copies to one row
    per agent first and leaves as it was; a sleeping agent's row holds."""
    cfg, _ = _tiny("dense")
    p = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, labels = TaskTokenDistribution(
        vocab_size=cfg.vocab_size, num_tasks=1).sample(
        torch.Generator().manual_seed(1), 0, 2 * 1 * 2, 8)
    toks, labels = (x.reshape(2, 1, 2, 8) for x in (toks, labels))

    def loss_fn(q, t, lab):
        return lm_loss(q, cfg, t, lab)

    wide = {k: v.expand((2,) + v.shape) for k, v in p.items()}
    new_wide = train.local_round(loss_fn, wide, toks, labels, lr=0.1)
    assert all(torch.equal(wide[k][1], p[k]) for k in p)     # untouched
    rows = {k: v.clone() for k, v in wide.items()}
    new = train.local_round(loss_fn, rows, toks, labels, lr=0.1)
    assert all(new[k] is rows[k] for k in p)
    assert all(torch.equal(new[k], new_wide[k]) for k in p)
    assert not all(torch.equal(new[k][0], p[k]) for k in p)
    rows = {k: v.clone() for k, v in wide.items()}
    held = train.local_round(loss_fn, rows, toks, labels, lr=0.1,
                             act=torch.tensor([True, False]))
    assert all(torch.equal(held[k][1], p[k])
               and torch.equal(held[k][0], new[k][0]) for k in p)


def test_program_audit_covers_the_launcher_programs():
    """``--layer programs`` runs the four launchers at a reduced size and
    audits their records: clean as built; a launcher program that streams
    is no JX4 finding (it is built per call), an undonated AsyncState is
    JX5 and a captured replay that broke donation JX3, as for cached
    programs."""
    from repro_torch.analysis import programs
    recs = programs._tiny_launchers("cpu")
    assert sorted(r.name for r in recs) == [
        "serve_decode", "serve_prefill", "train_fl_round", "train_step"]
    assert all(r.cache_key is None for r in recs) and \
        programs.audit_programs(recs) == []
    (fl,) = [r for r in recs if r.name == "train_fl_round"]
    assert fl.async_argnums == (0,)
    bad = dataclasses.replace(fl, streaming=True, donate_argnums=(),
                              captured=True, in_place=False)
    found = programs.audit_programs([bad])
    assert sorted(f.rule for f in found) == ["JX3", "JX5"]
    assert all("built per call" in f.message for f in found)
