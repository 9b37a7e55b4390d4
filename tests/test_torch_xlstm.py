"""The port's xLSTM (``repro_torch.models.xlstm``) against the JAX package,
on the same numpy inputs and on JAX parameters carried across by
``repro_torch.convert``, at the reduced size (2 layers: mLSTM, sLSTM; d
256): ``mlstm_recurrent`` and ``mlstm_chunked`` (a T that is not a
multiple of the chunk, empty and carried states), ``slstm_apply``, both
blocks, the logits, ``lm_loss`` and its gradient from an empty state
against ``jax.grad``, and a prefill followed by 8 greedy decode steps
against the JAX steps. Within the port: chunked equals recurrent, the
sLSTM's state splits a sequence, the tuple-``blocks`` convert round trip
bit for bit, the parameter counts, the load-time cast, remat, and the
serving and training entry points on the CPU."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, params_from_numpy)
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import api, xlstm  # noqa: E402
from repro_torch.models.layers import namespace  # noqa: E402

ARCH = "xlstm-125m"
# f32 whole model or cell: the same ops, sums in another order
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
# chunked vs recurrent: two algorithms, the reference's own tolerance
# (tests/test_models.py)
FORMS_TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_RTOL = 1e-4
B, PROMPT, GEN = 2, 20, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small models run about as fast on one,
    and in a parallel test run more threads per worker oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=SLICE_TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(seed=0, layers=2, **change):
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH), num_layers=layers),
                               **change)
    cfg = dataclasses.replace(reduced(get_arch(ARCH), num_layers=layers),
                              **change)
    jp = jxlstm.init(jax.random.PRNGKey(seed), jcfg)
    model = xlstm.init(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(jp, cfg, device="cpu"))
    return jcfg, cfg, jp, model


def _tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _cell_inputs(T, seed=0, Bc=2, H=2, hd=8):
    """q, k, v (B, H, T, hd), li, lf (B, H, T) as numpy f32 (lf a
    log-sigmoid, as the block makes it)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((Bc, H, T, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((Bc, H, T)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((Bc, H, T)).astype(np.float32) + 1.0))
    return q, k, v, li, lf


def _state_pair(seed=9, Bc=2, H=2, hd=8):
    rng = np.random.default_rng(seed)
    C = rng.standard_normal((Bc, H, hd, hd)).astype(np.float32)
    n = rng.standard_normal((Bc, H, hd)).astype(np.float32)
    m = rng.standard_normal((Bc, H)).astype(np.float32)
    return (tuple(jnp.asarray(a) for a in (C, n, m)),
            tuple(_t(a) for a in (C, n, m)))


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_recurrent_matches_jax(carried):
    ins = _cell_inputs(11)
    jst, st = _state_pair() if carried else (None, None)
    jh, js = jxlstm.mlstm_recurrent(*map(jnp.asarray, ins), state=jst)
    h, s = xlstm.mlstm_recurrent(*map(_t, ins), state=st)
    _close(h, jh)
    for a, b in zip(s, js):
        _close(a, b)


@pytest.mark.parametrize("T,chunk", [(37, 8), (37, 16), (32, 8), (5, 5)])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunked_matches_jax(T, chunk, carried):
    """T = 37 is not a multiple of the chunk: the padded steps add
    nothing and decay nothing."""
    ins = _cell_inputs(T, seed=T)
    jst, st = _state_pair() if carried else (None, None)
    jh, js = jxlstm.mlstm_chunked(*map(jnp.asarray, ins), state=jst,
                                  chunk=chunk)
    h, s = xlstm.mlstm_chunked(*map(_t, ins), state=st, chunk=chunk)
    _close(h, jh)
    for a, b in zip(s, js):
        _close(a, b)


@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunked_matches_recurrent(carried):
    """The port's two forms agree (``tests/test_models.py``'s check)."""
    ins = tuple(map(_t, _cell_inputs(37, seed=3)))
    st = _state_pair()[1] if carried else None
    h1, s1 = xlstm.mlstm_recurrent(*ins, state=st)
    h2, s2 = xlstm.mlstm_chunked(*ins, state=st, chunk=8)
    _close(h2, h1, FORMS_TOL)
    for a, b in zip(s2, s1):
        _close(a, b, FORMS_TOL)


def _slstm_pair(seed=2):
    jcfg = jreduced(jget_arch(ARCH))
    jcell = jxlstm.init_slstm_block(jax.random.PRNGKey(seed), jcfg)["cell"]
    return jcfg, jcell, namespace(params_from_numpy(jcell, device="cpu"))


def test_slstm_apply_matches_jax_and_splits_its_state():
    """Against the JAX cell, from an empty state and from a carried one;
    two halves through the state equal the whole (``tests/test_models.py``'s
    streaming check)."""
    jcfg, jcell, cell = _slstm_pair()
    x = np.random.default_rng(4).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    jy, js = jxlstm.slstm_apply(jcell, jnp.asarray(x))
    y, s = xlstm.slstm_apply(cell, _t(x))
    _close(y, jy)
    for a, b in zip(s, js):
        _close(a, b)
    a, st = xlstm.slstm_apply(cell, _t(x[:, :9]))
    b, _ = xlstm.slstm_apply(cell, _t(x[:, 9:]), st)
    _close(torch.cat([a, b], 1), y)
    jb, _ = jxlstm.slstm_apply(jcell, jnp.asarray(x[:, 9:]),
                               tuple(jnp.asarray(_np(t)) for t in st))
    _close(b, jb)


def test_full_width_slstm_is_chaotic_in_both_packages():
    """At xlstm-125m's full width (d 768, 4 heads of 192) the reference's
    sLSTM recurrence amplifies a perturbation: its recurrent weights are
    drawn with the first axis (H = 4) as fan-in, std 0.5, a gain of ~7 a
    step (ROADMAP C10). A relative 1e-7 change of the input moves the
    reference's own output by O(1) within 96 steps; the port follows the
    reference as closely as the reference follows itself: within 1e-4
    over the first 16 steps, and apart by the same order after."""
    jcfg = jget_arch(ARCH)
    jcell = jxlstm.init_slstm_block(jax.random.PRNGKey(1), jcfg)["cell"]
    cell = namespace(params_from_numpy(jcell, device="cpu"))
    x = np.random.default_rng(0).standard_normal(
        (1, 96, jcfg.d_model)).astype(np.float32)
    y0, _ = jxlstm.slstm_apply(jcell, jnp.asarray(x))
    y1, _ = jxlstm.slstm_apply(jcell, jnp.asarray(x * (1 + 1e-7)))
    y, _ = xlstm.slstm_apply(cell, _t(x))
    self_d = np.abs(np.asarray(y0) - np.asarray(y1)).max(axis=(0, 2))
    port_d = np.abs(np.asarray(y0) - _np(y)).max(axis=(0, 2))
    assert self_d[:16].max() < 1e-4 and port_d[:16].max() < 1e-4
    assert self_d[-16:].max() > 0.1
    assert port_d[-16:].max() < 10 * self_d[-16:].max()


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("with_state", [False, True])
def test_blocks_match_jax(kind, with_state):
    """One block of each kind, T = 13 (the mLSTM chunk is T itself),
    from no state and from the state of a first pass."""
    jcfg, cfg = jreduced(jget_arch(ARCH)), reduced(get_arch(ARCH))
    init = {"mlstm": jxlstm.init_mlstm_block,
            "slstm": jxlstm.init_slstm_block}[kind]
    jfn = {"mlstm": jxlstm.mlstm_block, "slstm": jxlstm.slstm_block}[kind]
    fn = {"mlstm": xlstm.mlstm_block, "slstm": xlstm.slstm_block}[kind]
    jbp = init(jax.random.PRNGKey(5), jcfg)
    bp = namespace(params_from_numpy(jbp, device="cpu"))
    rng = np.random.default_rng(6)
    x1, x2 = (rng.standard_normal((B, 13, cfg.d_model)).astype(np.float32)
              for _ in range(2))
    jst = st = None
    if with_state:
        _, jst = jfn(jbp, jcfg, jnp.asarray(x1))
        with torch.no_grad():
            _, st = fn(bp, cfg, _t(x1))
    jy, jns = jfn(jbp, jcfg, jnp.asarray(x2), jst)
    with torch.no_grad():
        y, ns = fn(bp, cfg, _t(x2), st)
    _close(y, jy)
    _close(ns["conv"], jns["conv"])
    for a, b in zip(ns["cell"], jns["cell"]):
        _close(a, b)


def test_logits_match_jax():
    jcfg, cfg, jp, model = _pair()
    toks = _tokens(cfg, 40)
    jlogits, _, _ = jxlstm.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        logits, caches, aux = xlstm.forward(model, cfg, _t(toks).long())
    assert caches is None and float(aux) == 0.0
    assert logits.shape == (B, 40, cfg.vocab_size)
    _close(logits, jlogits)


def _top2_margin(logits):
    top = np.sort(_np(logits), axis=-1)
    return top[:, -1] - top[:, -2]


def test_prefill_and_decode_match_jax():
    """The prefill's last-position logits and every layer's state, then
    8 decode steps (the mLSTM's recurrent form) against the JAX steps:
    logits, and greedy tokens where the reference's top two differ by
    more than 1e-3."""
    jcfg, cfg, jp, model = _pair()
    prompts = _tokens(cfg, PROMPT)
    jc = jxlstm.init_cache(jcfg, B, PROMPT + GEN)
    c = xlstm.init_cache(cfg, B, PROMPT + GEN, device="cpu")
    jlast, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, jc, {"tokens": jnp.asarray(prompts)})
    last, c = steps.make_prefill_step(cfg)(model, c,
                                           {"tokens": _t(prompts).long()})
    _close(last, jlast, msg="prefill logits")
    for layer, jlayer in zip(c, jc):
        _close(layer["conv"], jlayer["conv"])
        for a, b in zip(layer["cell"], jlayer["cell"]):
            _close(a, b)
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    dec = steps.make_decode_step(cfg)
    jnxt = jnp.argmax(jlast[:, -1], axis=-1).astype(jnp.int32)[:, None]
    nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    for i in range(GEN):
        idx = PROMPT + i
        jlogits, _, _ = jxlstm.forward(jp, jcfg, jnxt, caches=jc)
        with torch.no_grad():
            logits, _, _ = xlstm.forward(model, cfg, nxt.long(), caches=c)
        _close(logits, jlogits, msg=f"decode step {i}")
        jnxt, jc = jdec(jp, jc, {"tokens": jnxt,
                                 "cache_index": jnp.int32(idx)})
        nxt, c = dec(model, c, {"tokens": nxt.long(), "cache_index": idx})
        clear = _top2_margin(np.asarray(jlogits)[:, -1]) > 1e-3
        assert np.array_equal(nxt.numpy()[clear], np.asarray(jnxt)[clear])
        jnxt = jnp.asarray(nxt.numpy())


def test_decode_equals_the_full_forward():
    _, cfg, _, model = _pair()
    toks = _t(_tokens(cfg, PROMPT + 1)).long()
    with torch.no_grad():
        full, _, _ = xlstm.forward(model, cfg, toks)
        c = xlstm.init_cache(cfg, B, PROMPT + 1, device="cpu")
        _, c, _ = xlstm.forward(model, cfg, toks[:, :PROMPT], caches=c)
        step, _, _ = xlstm.forward(model, cfg, toks[:, PROMPT:], caches=c)
    _close(step[:, -1], full[:, -1])


def test_lm_loss_and_gradient_match_jax():
    """From an empty state (m0 = -inf in every cell) the gradient is
    finite and matches ``jax.grad``, within 1e-4 of each leaf's max."""
    jcfg, cfg, jp, _ = _pair()
    toks = _tokens(cfg, 40)
    labels = np.roll(toks, -1, axis=1)
    labels[:, ::4] = -1
    jl, jg = jax.value_and_grad(lambda p: japi.lm_loss(
        p, jcfg, jnp.asarray(toks), jnp.asarray(labels)))(jp)
    p = params_from_numpy(jp, device="cpu")
    l, g = steps.value_and_grad(
        lambda q: api.lm_loss(q, cfg, _t(toks).long(), _t(labels).long()), p)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    want = params_from_numpy(jg, device="cpu")
    assert set(g) == set(want) and len(g) == 30
    for k in want:
        assert bool(torch.isfinite(g[k]).all()), k
        scale = float(want[k].abs().max())
        err = float((g[k] - want[k]).abs().max())
        assert err <= GRAD_RTOL * max(scale, 1e-30), (k, err, scale)


def test_remat_gives_the_same_loss_and_gradient():
    cfg = reduced(get_arch(ARCH), d_model=64)
    p = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 12),
                         generator=torch.Generator().manual_seed(1))

    def loss(c):
        return lambda q: api.lm_loss(q, c, toks, toks)

    l0, g0 = steps.value_and_grad(loss(cfg), p)
    l1, g1 = steps.value_and_grad(loss(dataclasses.replace(cfg, remat=True)),
                                  p)
    assert torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)


@pytest.mark.parametrize("layers", [2, 5])
def test_convert_round_trip_of_the_tuple_blocks(layers):
    """``blocks`` is a tuple of per-layer dicts: the names carry the layer
    already, so nothing is sliced (a stacked-leaf reading would cut a
    weight axis silently); back to the same tree, bit for bit."""
    jcfg, cfg, jp, model = _pair(seed=6, layers=layers)
    if layers == 5:
        assert cfg.xlstm.slstm_at == (1, 4)
    jleaves, jdef = jax.tree.flatten(jp)
    flat = lm_params_from_numpy(jp, cfg, device="cpu")
    assert set(flat) == set(model.state_dict())
    for name, t in flat.items():
        assert t.shape == model.state_dict()[name].shape, name
    stacked = xlstm.stack_params(model)
    assert len(stacked) == len(jleaves)
    assert set(stacked) == set(params_from_numpy(jp, device="cpu"))
    back = lm_params_to_numpy(model, cfg)
    leaves, tdef = jax.tree.flatten(back)
    assert tdef == jdef
    for a, b in zip(leaves, jleaves):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)


def test_param_counts_equal_the_references():
    """Counted params equal the JAX ``count_params`` (reduced; full size
    from shapes alone: 171 leaves); ``param_count()`` is the reference's
    rough formula (ROADMAP C9)."""
    jcfg, cfg, jp, model = _pair()
    assert api.count_params(model) == japi.count_params(jp)
    full, jfull = get_arch(ARCH), jget_arch(ARCH)
    jshapes = jax.eval_shape(lambda k: jxlstm.init(k, jfull),
                             jax.random.PRNGKey(0))
    meta = xlstm.init(full, device="meta")
    assert len(xlstm.stack_params(meta)) == len(jax.tree.leaves(jshapes)) \
        == 171
    assert api.count_params(meta) == japi.count_params(jshapes) \
        == 138_047_296
    assert full.param_count() == jfull.param_count() == 133_909_248
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("cut", [None, 2, 5])
def test_config_equals_jax_field_by_field(cut):
    ours, theirs = get_arch(ARCH), jget_arch(ARCH)
    if cut is not None:
        ours, theirs = reduced(ours, num_layers=cut), jreduced(theirs,
                                                               num_layers=cut)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


def test_load_time_cast_is_bit_equal():
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="bfloat16")
    plain = xlstm.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    cast = xlstm.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    xlstm.cast_for_serving(cast, cfg)
    for name, p in cast.named_parameters():
        assert (p.dtype == torch.float32) == xlstm._read_in_f32(name), name
    toks = _t(_tokens(cfg, PROMPT)).long()
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    outs = []
    for model in (plain, cast):
        c = xlstm.init_cache(cfg, B, PROMPT + 3, device="cpu")
        last, c = prefill(model, c, {"tokens": toks})
        seq = [last]
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        for i in range(2):
            nxt, c = decode(model, c, {"tokens": nxt.long(),
                                       "cache_index": PROMPT + i})
            seq.append(nxt)
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_serve_and_train_run_on_the_cpu():
    """Serving, standard training and a federated run (sparse plan, int8
    with error feedback) on the CPU, where no kernel launches."""
    cfg = reduced(get_arch(ARCH), d_model=64)
    res = serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu",
                verbose=False)
    assert res.tokens.shape == (2, 3)
    assert all(v == 0 for ph in res.launches.values() for v in ph.values())
    _, hist = train.train_standard(cfg, steps=3, batch=2, seq=8, lr=1e-2,
                                   log_every=100, device="cpu")
    assert len(hist) == 3 and np.all(np.isfinite(hist))
    stacked, fhist, E = train.train_federated(
        cfg, rounds=2, agents=2, tasks=1, local_steps=1, batch=1, seq=8,
        lr=1e-2, codec="int8", consensus_plan="sparse", device="cpu")
    assert len(stacked) == 30 and all(v.shape[0] == 2
                                      for v in stacked.values())
    assert np.all(np.isfinite(fhist)) and E > 0
