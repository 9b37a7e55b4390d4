"""The port's decoder-only transformer family (dense, SWA, qk-norm, MoE)
against the JAX package, on the same numpy inputs and on JAX parameters
carried across by ``repro_torch.convert``, for every reduced ``dense``,
``moe`` and ``vlm`` arch: the forward's logits and aux loss, ``lm_loss``,
and a prefill followed by 8 decode steps through the caches against the
JAX ``make_prefill_step`` / ``make_decode_step`` (h2o-danube and mixtral
with a window of 64 and an 80-token prompt, so the circular cache wraps).
Within the port: decode equals the full forward, the load-time cast
changes no bit and keeps the f32-read tensors in f32, ``convert`` puts
every layer in its place, and ``serve`` and the ``serve_lm`` twin run on
the CPU (where the kernels' plain versions run)."""
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
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_arch, list_archs, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import serve_lm, steps  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

# f32 whole model: the same ops, matmul sums in another order
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
# f32 scalars (aux loss, lm_loss): one mean over a few hundred terms
SCALAR_TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = [a for a in list_archs()
         if get_arch(a).family in ("dense", "moe", "vlm")]
B, PROMPT, GEN = 2, 80, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=SLICE_TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=msg)


def _pair(arch, seed=0, **change):
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), **change)
    cfg = dataclasses.replace(reduced(get_arch(arch)), **change)
    jp = jtransformer.init(jax.random.PRNGKey(seed), jcfg)
    model = transformer.init(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(jp, cfg, device="cpu"))
    return jcfg, cfg, jp, model


def _tokens(cfg, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_every_transformer_arch_is_covered():
    assert sorted(ARCHS) == ["chameleon-34b", "deepseek-7b", "granite-8b",
                             "h2o-danube-3-4b", "mixtral-8x7b",
                             "qwen2-moe-a2.7b", "stablelm-3b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """Logits of all positions and the summed MoE aux loss, no cache,
    S = 80 (longer than the reduced window of 64)."""
    jcfg, cfg, jp, model = _pair(arch)
    toks = _tokens(cfg, PROMPT)
    jlogits, _, jaux = jtransformer.forward(jp, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        logits, caches, aux = transformer.forward(model, cfg,
                                                  torch.from_numpy(toks))
    assert caches is None and logits.shape == (B, PROMPT, cfg.vocab_size)
    _close(logits, jlogits, msg="logits")
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, jaux, SCALAR_TOL, "aux")
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """Next-token cross-entropy over valid labels (a quarter masked with
    -1) plus the aux loss."""
    jcfg, cfg, jp, model = _pair(arch)
    toks = _tokens(cfg, 32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, ::4] = -1
    want = japi.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    with torch.no_grad():
        got = api.lm_loss(model, cfg, torch.from_numpy(toks),
                          torch.from_numpy(labels))
    _close(got, want, SCALAR_TOL)


def test_lm_loss_of_all_masked_labels_is_the_aux_loss():
    _, cfg, _, model = _pair("qwen2-moe-a2.7b")
    toks = torch.from_numpy(_tokens(cfg, 16))
    with torch.no_grad():
        loss = api.lm_loss(model, cfg, toks, torch.full_like(toks, -1))
        _, _, aux = transformer.forward(model, cfg, toks)
    assert torch.equal(loss, aux)


def _top2_margin(logits):
    top = np.sort(_np(logits), axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b",
                                  "qwen2-moe-a2.7b", "chameleon-34b",
                                  "stablelm-3b"])
def test_prefill_and_decode_match_jax(arch):
    """The prefill's last-position logits and every cache, then 8 decode
    steps' logits and greedy tokens (where the reference's top two differ
    by more than 1e-3), against the JAX steps. SWA archs: window 64 < the
    80-token prompt, so the prefill fills the circular cache past its end
    and each decode step overwrites slot pos % 64."""
    jcfg, cfg, jp, model = _pair(arch)
    prompts = _tokens(cfg, PROMPT)
    max_len = PROMPT + GEN
    jc = jtransformer.init_cache(jcfg, B, max_len)
    c = transformer.init_cache(cfg, B, max_len, device="cpu")
    circular = cfg.sliding_window > 0
    assert c[0]["k"].shape[1] == (cfg.sliding_window if circular
                                  else max_len)
    jlast, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, jc, {"tokens": jnp.asarray(prompts)})
    last, c = steps.make_prefill_step(cfg)(model, c,
                                           {"tokens": torch.from_numpy(prompts)})
    assert last.shape == (B, 1, cfg.vocab_size)
    _close(last, jlast, msg="prefill logits")
    for i in range(cfg.num_layers):
        for kv in ("k", "v"):
            _close(c[i][kv], jc[kv][i], msg=f"layer {i} cache {kv}")

    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    jlogits = jax.jit(lambda p, c, t, i: jtransformer.forward(
        p, jcfg, t, caches=c, cache_index=i)[0])
    decode = steps.make_decode_step(cfg)
    tok = np.asarray(jnp.argmax(jlast[:, -1], -1), np.int32)[:, None]
    for i in range(GEN):
        idx = PROMPT + i
        want = jlogits(jp, jc, jnp.asarray(tok), jnp.int32(idx))
        with torch.no_grad():
            got, _, _ = transformer.forward(model, cfg, torch.tensor(tok),
                                            caches=c, cache_index=idx)
        _close(got, want, msg=f"decode step {i} logits")
        jn, jc = jdecode(jp, jc, {"tokens": jnp.asarray(tok),
                                  "cache_index": jnp.int32(idx)})
        n, c = decode(model, c, {"tokens": torch.tensor(tok),
                                 "cache_index": idx})
        sure = _top2_margin(want[:, -1]) > 1e-3
        assert np.array_equal(n.numpy()[sure], np.asarray(jn)[sure]), i
        tok = np.asarray(jn, np.int32)
    for i in range(cfg.num_layers):
        _close(c[i]["k"], jc["k"][i], msg=f"layer {i} cache k after decode")


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-moe-a2.7b"])
def test_decode_matches_full_forward(arch):
    """Prefill + one decode step through the caches == the full forward
    at the last position (prompt longer than the window). The MoE runs at
    capacity factor 8.0, as the JAX package's own check does: at the
    default factor the full forward drops late tokens that a one-token
    decode keeps."""
    cfg = reduced(get_arch(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 70))
    caches = transformer.init_cache(cfg, B, 80, device="cpu")
    last, caches = steps.make_prefill_step(cfg)(model, caches,
                                                {"tokens": toks})
    nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    with torch.no_grad():
        lg2, _, _ = transformer.forward(model, cfg, nxt, caches=caches,
                                        cache_index=70)
        full, _, _ = transformer.forward(model, cfg, torch.cat([toks, nxt], 1))
    _close(last[:, 0], full[:, -2], msg="prefill vs full")
    _close(lg2[:, 0], full[:, -1], msg="decode vs full")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "chameleon-34b"])
def test_load_time_cast_is_bit_equal(arch):
    """``cast_for_serving`` keeps the norms (q/k norms included), the
    router and the shared gate in f32 and casts the rest to bf16; a bf16
    prefill and two decode steps give the same bits either way."""
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype="bfloat16")

    def make():
        return transformer.init(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")

    plain, cast = make(), transformer.cast_for_serving(make(), cfg)
    kept = set()
    for name, p in cast.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        f32 = leaf.endswith("norm") or leaf in ("router", "shared_gate")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
        kept |= {leaf} if f32 else set()
    assert kept >= {"attn_norm", "mlp_norm", "final_norm"}
    assert kept >= ({"router", "shared_gate"} if cfg.moe
                    else {"q_norm", "k_norm"})
    toks = torch.from_numpy(_tokens(cfg, 70, seed=2))
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    outs = []
    for model in (plain, cast):
        c = transformer.init_cache(cfg, B, 73, device="cpu")
        last, c = prefill(model, c, {"tokens": toks})
        seq = [last]
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        for i in range(2):
            nxt, c = decode(model, c, {"tokens": nxt, "cache_index": 70 + i})
            seq.append(nxt)
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-moe-a2.7b"])
def test_convert_unstacks_layers_in_order(arch):
    """Three layers: block i of the port holds row i of every stacked JAX
    leaf (MoE expert stacks stay (E, d, f))."""
    jcfg = jreduced(jget_arch(arch), num_layers=3)
    cfg = reduced(get_arch(arch), num_layers=3)
    jp = jtransformer.init(jax.random.PRNGKey(9), jcfg)
    flat = lm_params_from_numpy(jp, cfg, device="cpu")
    model = transformer.init(cfg, device="cpu")
    assert set(flat) == set(model.state_dict())
    model.load_state_dict(flat)
    sd = model.state_dict()
    for layer in range(3):
        src = jax.tree.map(lambda a: a[layer], jp["blocks"])
        for name, t in params_from_numpy(src, device="cpu").items():
            assert torch.equal(sd[f"blocks.{layer}.{name}"], t), (layer, name)
    if cfg.moe is not None:
        E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
        assert sd["blocks.0.mlp.w_gate"].shape == (E, d, f)
    for name in ("embed", "final_norm", "unembed"):
        assert torch.equal(sd[name], torch.from_numpy(np.array(jp[name])))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_the_model(arch):
    """``count_params`` equals the JAX package's count of its own params;
    ``param_count()`` leaves out what the JAX formula leaves out: the
    shared expert's gate (d per layer) and the q/k norms (2·hd)."""
    jcfg, cfg, jp, model = _pair(arch)
    n = api.count_params(model)
    assert n == japi.count_params(jp)
    left_out = cfg.num_layers * (
        (cfg.d_model if cfg.moe is not None and cfg.moe.num_shared_experts
         else 0) + (2 * cfg.head_dim_ if cfg.use_qk_norm else 0))
    assert n == cfg.param_count() + left_out
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-moe-a2.7b",
                                  "chameleon-34b"])
def test_serve_runs_on_cpu(arch):
    """The entry point end to end on the CPU: the wrappers run their plain
    versions there, so no kernel is launched."""
    cfg = reduced(get_arch(arch))
    res = serve(cfg, batch=B, prompt_len=70, gen=3, device="cpu",
                verbose=False)
    assert res.tokens.shape == (B, 3) and res.tokens.dtype == torch.int32
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
    assert bool(torch.isfinite(res.last_logits).all())
    assert res.launches == {p: {"rglru_scan": 0, "flash_attention": 0}
                            for p in ("prefill", "decode")}


def test_serve_lm_twin_runs_on_cpu(capsys):
    """The twin of ``examples/serve_lm.py``: three reduced archs at batch
    2, prompt 32, 8 tokens."""
    res = serve_lm.run(device="cpu")
    assert list(res) == ["stablelm-3b", "h2o-danube-3-4b",
                         "recurrentgemma-9b"]
    for r in res.values():
        assert r.tokens.shape == (2, 8)
        assert bool(torch.isfinite(r.last_logits).all())
    assert "SWA 64" in capsys.readouterr().out


def test_serve_cli_defaults_to_the_reference_arch(monkeypatch):
    """With no arguments the CLI serves h2o-danube-3-4b, the JAX
    package's default, on the card."""
    from repro_torch.launch import serve as serve_mod
    seen = {}
    monkeypatch.setattr(serve_mod, "serve",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    monkeypatch.setattr("sys.argv", ["serve"])
    serve_mod.main()
    assert seen["cfg"] is get_arch("h2o-danube-3-4b")
    assert seen["device"] == "cuda"


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_plain_mlp_with_biases_matches_jax(act):
    """``mlp_kind="plain"`` (``w_up``, ``b_up``, ``w_down``, ``b_down``)
    with each activation, biases nonzero."""
    from repro.models import layers as jL
    jcfg = dataclasses.replace(jreduced(jget_arch("stablelm-3b")),
                               mlp_kind="plain", act=act)
    cfg = dataclasses.replace(reduced(get_arch("stablelm-3b")),
                              mlp_kind="plain", act=act)
    rng = np.random.default_rng(6)
    jp = dict(jL.init_mlp(jax.random.PRNGKey(2), jcfg))
    for b in ("b_up", "b_down"):
        jp[b] = jnp.asarray(rng.standard_normal(jp[b].shape), jnp.float32)
    tp = L.Mlp(cfg, device="cpu")
    tp.load_state_dict(params_from_numpy(jp, device="cpu"))
    x = rng.standard_normal((B, 9, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got = L.mlp_block(tp, cfg, torch.from_numpy(x))
    _close(got, jL.mlp_block(jp, jcfg, jnp.asarray(x)), dict(rtol=1e-5,
                                                             atol=1e-5))
