"""The port's whisper encoder-decoder (``repro_torch.models.encdec``)
against the JAX package, on the same numpy inputs and on JAX parameters
carried across by ``repro_torch.convert``, at the reduced size (2 + 2
layers, d 256, 32 frames): the sinusoid table ``==``, ``layer_norm``,
``encode``, ``compute_cross_kv``, teacher-forced logits, ``lm_loss`` and
its gradient against ``jax.grad``, and a prefill followed by 8 greedy
decode steps against the JAX steps. Within the port: the convert round
trip bit for bit with the reference's 35 leaves, the parameter count
(counted and ``param_count()``) against the reference's, the load-time
cast changes no bit, remat changes no bit, a decoder without frames or a
cross cache is refused, ``train_federated`` refuses the family, and the
serving and standard-training entry points run on the CPU."""
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy, params_from_numpy)
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import api, encdec, frontend  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ARCH = "whisper-large-v3"
# f32 whole model: the same ops, matmul sums in another order
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
# the loss: whisper ties its logits to an embedding of std 1, so a reduced
# model's first loss is ~100, not ln V; held relatively
LOSS_RTOL = 1e-5
# gradients, of each leaf's largest entry
GRAD_RTOL = 1e-4
B, PROMPT, GEN = 2, 12, 8


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


def _pair(seed=0, **change):
    """Reduced whisper in both packages, the JAX params and the port's
    module of the same numbers."""
    jcfg = dataclasses.replace(jreduced(jget_arch(ARCH)), **change)
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), **change)
    jp = jencdec.init(jax.random.PRNGKey(seed), jcfg)
    model = encdec.init(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(jp, cfg, device="cpu"))
    return jcfg, cfg, jp, model


def _frames(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.encdec.encoder_seq_len, cfg.d_model))
            * 0.02).astype(np.float32)


def _tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("length,channels", [(448, 256), (32, 64),
                                             (1500, 1280), (448, 1280)])
def test_sinusoids_equal_jax(length, channels):
    got = encdec.sinusoids(length, channels)
    want = np.asarray(jencdec.sinusoids(length, channels))
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = jL.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w),
                         jnp.asarray(b), 1e-6)
    got = L.layer_norm(_t(x).to(getattr(torch, dtype)), _t(w), _t(b), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    tol = SLICE_TOL if dtype == "float32" else dict(rtol=2.0 ** -7, atol=1e-2)
    _close(got, np.asarray(want, np.float32), tol)


def test_encode_and_cross_kv_match_jax():
    jcfg, cfg, jp, model = _pair()
    frames = _frames(cfg)
    jout = jencdec.encode(jp, jcfg, jnp.asarray(frames))
    jcross = jencdec.compute_cross_kv(jp, jcfg, jout)
    with torch.no_grad():
        out = encdec.encode(model, cfg, _t(frames))
        cross = encdec.compute_cross_kv(model, cfg, out)
    assert out.shape == (B, 32, cfg.d_model)
    _close(out, jout, msg="encoder states")
    assert len(cross) == cfg.num_layers
    for name in ("k", "v"):
        _close(torch.stack([c[name] for c in cross]), jcross[name],
               msg=f"cross {name}")


def test_training_logits_match_jax():
    """Teacher forcing (no cache): the encoder runs on the frames."""
    jcfg, cfg, jp, model = _pair()
    frames, toks = _frames(cfg), _tokens(cfg, 24)
    jlogits, jc, jaux = jencdec.forward(jp, jcfg, jnp.asarray(toks),
                                        embeddings=jnp.asarray(frames))
    with torch.no_grad():
        logits, caches, aux = encdec.forward(model, cfg, _t(toks),
                                             embeddings=_t(frames))
    assert caches is None and jc is None
    assert logits.shape == (B, 24, cfg.vocab_size)
    _close(logits, jlogits)
    assert float(aux) == float(jaux) == 0.0


def test_decoder_positions_wrap_at_the_table():
    """Positions past the 448-entry table read it mod 448, as the JAX
    forward does (the model's own context is 448)."""
    jcfg, cfg, jp, model = _pair()
    frames, toks = _frames(cfg), _tokens(cfg, 6)
    pos = np.broadcast_to(np.arange(445, 451, dtype=np.int32), (B, 6)).copy()
    jlogits, _, _ = jencdec.forward(jp, jcfg, jnp.asarray(toks),
                                    positions=jnp.asarray(pos),
                                    embeddings=jnp.asarray(frames))
    with torch.no_grad():
        logits, _, _ = encdec.forward(model, cfg, _t(toks),
                                      positions=_t(pos).long(),
                                      embeddings=_t(frames))
    _close(logits, jlogits)


def _top2_margin(logits):
    top = np.sort(_np(logits), axis=-1)
    return top[:, -1] - top[:, -2]


def test_prefill_and_decode_match_jax():
    """The prefill's last-position logits and every cache (self and
    cross), then 8 greedy decode steps' logits and tokens (where the
    reference's top two differ by more than 1e-3) against the JAX
    steps."""
    jcfg, cfg, jp, model = _pair()
    frames, prompts = _frames(cfg), _tokens(cfg, PROMPT)
    max_len = PROMPT + GEN
    jc = jencdec.init_cache(jcfg, B, max_len)
    c = encdec.init_cache(cfg, B, max_len, device="cpu")
    jlast, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, jc, {"tokens": jnp.asarray(prompts),
                 "frames": jnp.asarray(frames)})
    last, c = steps.make_prefill_step(cfg)(
        model, c, {"tokens": _t(prompts), "frames": _t(frames)})
    assert last.shape == (B, 1, cfg.vocab_size)
    _close(last, jlast, msg="prefill logits")
    for part in ("self", "cross"):
        for name in ("k", "v"):
            _close(torch.stack([layer[name] for layer in c[part]]),
                   jc[part][name], msg=f"{part} cache {name}")
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    dec = steps.make_decode_step(cfg)
    jnxt = jnp.argmax(jlast[:, -1], axis=-1).astype(jnp.int32)[:, None]
    nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    assert np.array_equal(nxt.numpy(), np.asarray(jnxt))
    for i in range(GEN):
        idx = PROMPT + i
        jlogits, _, _ = jencdec.forward(jp, jcfg, jnxt, caches=jc,
                                        cache_index=jnp.int32(idx))
        with torch.no_grad():
            logits, _, _ = encdec.forward(model, cfg, nxt.long(), caches=c,
                                          cache_index=idx)
        _close(logits, jlogits, msg=f"decode step {i}")
        jnxt, jc = jdec(jp, jc, {"tokens": jnxt,
                                 "cache_index": jnp.int32(idx)})
        nxt, c = dec(model, c, {"tokens": nxt.long(), "cache_index": idx})
        clear = _top2_margin(np.asarray(jlogits)[:, -1]) > 1e-3
        assert np.array_equal(nxt.numpy()[clear], np.asarray(jnxt)[clear])
        jnxt = jnp.asarray(nxt.numpy())


def test_decode_equals_the_full_forward():
    _, cfg, _, model = _pair()
    frames, toks = _t(_frames(cfg)), _t(_tokens(cfg, PROMPT + 1)).long()
    with torch.no_grad():
        full, _, _ = encdec.forward(model, cfg, toks, embeddings=frames)
        c = encdec.init_cache(cfg, B, PROMPT + 1, device="cpu")
        _, c, _ = encdec.forward(model, cfg, toks[:, :PROMPT], caches=c,
                                 cache_index=0, embeddings=frames)
        step, _, _ = encdec.forward(model, cfg, toks[:, PROMPT:], caches=c,
                                    cache_index=PROMPT)
    _close(step[:, -1], full[:, -1])


def test_lm_loss_and_gradient_match_jax():
    """``lm_loss`` relatively (the tied std-1 embedding makes it ~100)
    and its gradient against ``jax.grad`` on the JAX leaf structure."""
    jcfg, cfg, jp, _ = _pair()
    frames, toks = _frames(cfg), _tokens(cfg, 24)
    labels = np.roll(toks, -1, axis=1)
    labels[:, ::4] = -1
    jl, jg = jax.value_and_grad(lambda p: japi.lm_loss(
        p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
        embeddings=jnp.asarray(frames)))(jp)
    p = params_from_numpy(jp, device="cpu")
    l, g = steps.value_and_grad(
        lambda q: api.lm_loss(q, cfg, _t(toks).long(), _t(labels).long(),
                              embeddings=_t(frames)), p)
    assert float(jl) > 20                  # far from ln V = 6.2
    np.testing.assert_allclose(float(l), float(jl), rtol=LOSS_RTOL)
    want = params_from_numpy(jg, device="cpu")
    assert set(g) == set(want) and len(g) == 35
    for k in want:
        scale = float(want[k].abs().max())
        err = float((g[k] - want[k]).abs().max())
        assert err <= GRAD_RTOL * max(scale, 1e-30), (k, err, scale)


def test_remat_gives_the_same_loss_and_gradient():
    cfg = reduced(get_arch(ARCH), d_model=64)
    p = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    frames = frontend.audio_frame_embeddings(torch.Generator().manual_seed(1),
                                             cfg, B, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 10),
                         generator=torch.Generator().manual_seed(2))

    def loss(c):
        return lambda q: api.lm_loss(q, c, toks, toks, embeddings=frames)

    l0, g0 = steps.value_and_grad(loss(cfg), p)
    l1, g1 = steps.value_and_grad(loss(dataclasses.replace(cfg, remat=True)),
                                  p)
    assert torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k]) for k in g0)


def test_convert_round_trip_is_bit_for_bit_with_35_leaves():
    jcfg, cfg, jp, model = _pair(seed=4)
    jleaves, jdef = jax.tree.flatten(jp)
    assert len(jleaves) == 35
    stacked = encdec.stack_params(model)
    assert len(stacked) == 35
    assert set(stacked) == set(params_from_numpy(jp, device="cpu"))
    back = lm_params_to_numpy(model, cfg)
    leaves, tdef = jax.tree.flatten(back)
    assert tdef == jdef
    for a, b in zip(leaves, jleaves):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    # and the stacked dict goes to the same tree
    back2 = lm_params_to_numpy(
        {k: v for k, v in model.state_dict().items()}, cfg)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back2), jleaves))


def test_param_counts_equal_the_references():
    """Counted params equal the JAX ``count_params`` (reduced, on the
    module; full size, from shapes alone); ``param_count()`` equals the
    JAX formula, which counts an unembedding the model ties (ROADMAP
    C9)."""
    jcfg, cfg, jp, model = _pair()
    assert api.count_params(model) == japi.count_params(jp)
    full, jfull = get_arch(ARCH), jget_arch(ARCH)
    jshapes = jax.eval_shape(lambda k: jencdec.init(k, jfull),
                             jax.random.PRNGKey(0))
    meta = encdec.init(full, device="meta")
    assert api.count_params(meta) == japi.count_params(jshapes) \
        == 1_535_219_200
    assert full.param_count() == jfull.param_count() == 1_600_948_480
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
    assert ours.head_dim_ == theirs.head_dim_


def test_load_time_cast_is_bit_equal():
    cfg = dataclasses.replace(reduced(get_arch(ARCH)), dtype="bfloat16")
    plain = encdec.init(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    cast = encdec.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    encdec.cast_for_serving(cast, cfg)
    for name, p in cast.named_parameters():
        f32 = ".ln" in f".{name}" or name.startswith(("enc_norm", "dec_norm"))
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    frames = frontend.audio_frame_embeddings(
        torch.Generator().manual_seed(1), cfg, B, device="cpu")
    toks = _t(_tokens(cfg, PROMPT)).long()
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    outs = []
    for model in (plain, cast):
        c = encdec.init_cache(cfg, B, PROMPT + 3, device="cpu")
        last, c = prefill(model, c, {"tokens": toks, "frames": frames})
        seq = [last]
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        for i in range(2):
            nxt, c = decode(model, c, {"tokens": nxt.long(),
                                       "cache_index": PROMPT + i})
            seq.append(nxt)
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_decoder_without_frames_or_cross_cache_is_refused():
    _, cfg, _, model = _pair()
    with pytest.raises(ValueError, match="frames"):
        encdec.forward(model, cfg, _t(_tokens(cfg, 4)).long())


def test_frontend_shapes():
    cfg = reduced(get_arch(ARCH))
    x = frontend.audio_frame_embeddings(torch.Generator().manual_seed(0),
                                        cfg, 3, device="cpu")
    spec = frontend.audio_frame_spec(cfg, 3)
    assert x.shape == spec.shape == (3, 32, cfg.d_model)
    assert x.dtype == spec.dtype == torch.float32 and spec.is_meta
    assert 0.01 < float(x.std()) < 0.03
    ids = frontend.vlm_token_stream(torch.Generator().manual_seed(0), cfg,
                                    2, 9, device="cpu")
    assert ids.shape == (2, 9) and ids.dtype == torch.int32
    assert int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size


def test_train_federated_refuses_the_encoder_decoder():
    """The reference's federated loss passes no frames and its
    encoder-decoder then asserts (ROADMAP C8): the port refuses by
    name."""
    with pytest.raises(ValueError, match="encdec.*frames.*C8"):
        train.train_federated(reduced(get_arch(ARCH)), rounds=1, agents=2,
                              tasks=1, local_steps=1, batch=1, seq=4,
                              lr=1e-3, device="cpu")


def test_serve_and_train_standard_run_on_the_cpu():
    cfg = reduced(get_arch(ARCH), d_model=64)
    res = serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu",
                verbose=False)
    assert res.tokens.shape == (2, 3)
    assert res.n_params == api.count_params(encdec.init(cfg, device="cpu"))
    assert all(v == 0 for ph in res.launches.values() for v in ph.values())
    seen = []
    _, hist = train.train_standard(
        cfg, steps=3, batch=2, seq=8, lr=1e-2, log_every=100, device="cpu",
        callback=lambda t, p, m: seen.append(float(m["grad_norm"])))
    assert len(hist) == 3 and np.all(np.isfinite(hist + seen))
    assert hist[-1] < hist[0]
