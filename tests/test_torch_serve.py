"""The port's RecurrentGemma serving slice against the JAX package, and
its own contracts.

Against JAX, on the same numpy inputs and on JAX parameters carried across
by ``repro_torch.convert``: the layers and blocks one by one in f32, then
the whole slice at ``reduced(recurrentgemma-9b, num_layers=5)`` (window 64,
4 heads, 1 kv head) with prompts longer than the window, so the circular
cache wraps: the prefill's last-position logits and 8 greedy decode steps,
in f32 and in bf16. Within the port: decode equals the full forward, the
load-time cast changes no bit, every config equals JAX's field by field,
``get_model`` resolves the transformer families and refuses the families
not ported yet, the layer options the transformer family sets match JAX,
and ``serve`` runs end to end on the CPU (where the kernels' plain
versions run)."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import encdec, rglru, transformer, xlstm  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# f32 modules: the same ops, matmul sums in another order
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
# f32 recurrent state: sqrt(1 - exp(2·log_a)) cancels as a → 1, so a 1-ulp
# difference between XLA's and PyTorch's exp grows by 1/(2|log_a|) (up to
# ~1e-4 relative in the input multiplier at this init), and h carries it
STATE_TOL = dict(rtol=1e-5, atol=5e-5)
# f32 whole slice: 5 layers of such differences, softcapped logits
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 whole slice: XLA and PyTorch round bf16 at different points
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
ARCH = "recurrentgemma-9b"
CFG = reduced(get_arch(ARCH), num_layers=5)
JCFG = jreduced(jget_arch(ARCH), num_layers=5)
B, PROMPT, GEN = 2, 80, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=MODULE_TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), **tol, err_msg=msg)


def _loaded(module, jtree):
    module.load_state_dict(params_from_numpy(jtree, device="cpu"))
    return module


def _x(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# modules vs JAX, f32
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    xj, xt = _x(rng, 2, 7, 3, 16)
    wj, wt = _x(rng, 16)
    _close(L.rms_norm(xt, wt, 1e-6), jL.rms_norm(xj, wj, 1e-6))
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    inv = torch.from_numpy(L.rope_freqs(16, 10000.0))
    _close(L.apply_rope(xt, torch.from_numpy(pos), inv),
           jL.apply_rope(xj, jnp.asarray(pos), 10000.0))


@pytest.fixture(scope="module")
def attn_pair():
    jp = jL.init_attention(jax.random.PRNGKey(1), JCFG)
    return jp, _loaded(L.Attention(CFG, device="cpu"), jp)


def _attn_both(pair, x, pos, window, cache, idx):
    jp, tp = pair
    jout, jc = jL.attention_block(
        jp, JCFG, x[0], jnp.asarray(pos), window=window,
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()},
        cache_index=None if idx is None else jnp.int32(idx))
    with torch.no_grad():
        out, c = L.attention_block(
            tp, CFG, x[1], torch.from_numpy(pos), window=window,
            cache=None if cache is None else {k: torch.from_numpy(v)
                                              for k, v in cache.items()},
            cache_index=idx)
    _close(out, jout, msg="attention out")
    if cache is not None:
        for k in ("k", "v"):
            _close(c[k], jc[k], msg=f"cache {k}")
        return {k: _np(c[k]) for k in ("k", "v")}


@pytest.mark.parametrize("case", ["no_cache", "linear", "circular"])
def test_attention_block_matches_jax(attn_pair, case):
    """No cache (S = 48); a linear cache (prefill 40, then a decode step at
    40); the circular window cache (prefill 80 > C = 64, which wraps, then
    a decode step at 80)."""
    rng = np.random.default_rng(2)
    d, hd, K = CFG.d_model, CFG.head_dim_, CFG.num_kv_heads
    S = {"no_cache": 48, "linear": 40, "circular": 80}[case]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    x = _x(rng, B, S, d)
    if case == "no_cache":
        _attn_both(attn_pair, x, pos, CFG.sliding_window, None, None)
        return
    window = 0 if case == "linear" else CFG.sliding_window
    C = 64
    cache = {k: np.zeros((B, C, K, hd), np.float32) for k in ("k", "v")}
    cache = _attn_both(attn_pair, x, pos, window, cache, 0)
    step = np.full((B, 1), S, np.int32)
    _attn_both(attn_pair, _x(rng, B, 1, d), step, window, cache, S)


def test_conv1d_matches_jax():
    rng = np.random.default_rng(3)
    W = 48
    jp = jrglru.init_conv1d(jax.random.PRNGKey(4), W, 4, jnp.float32)
    tp = _loaded(rglru.Conv1d(W, 4, torch.float32, device="cpu"), jp)
    x = _x(rng, B, 9, W)
    st = _x(rng, B, 3, W)
    for state in (None, st):
        jy, js = jrglru.conv1d_apply(jp, x[0], None if state is None
                                     else state[0])
        y, s = rglru.conv1d_apply(tp, x[1], None if state is None
                                  else state[1])
        _close(y, jy)
        _close(s, js)


def test_recurrent_block_prefill_and_decode_match_jax():
    rng = np.random.default_rng(5)
    jbp = jrglru.init_recurrent_block(jax.random.PRNGKey(6), JCFG)
    tbp = _loaded(rglru.RecurrentBlock(CFG, device="cpu"), jbp)
    W = CFG.d_model
    jst = {"conv": jnp.zeros((B, 3, W)), "h": jnp.zeros((B, W))}
    tst = {"conv": torch.zeros(B, 3, W), "h": torch.zeros(B, W)}
    for S in (20, 1):                      # prefill, then one decode step
        x = _x(rng, B, S, CFG.d_model)
        jy, jst = jrglru.recurrent_block(jbp, JCFG, x[0], jst)
        with torch.no_grad():
            y, tst = rglru.recurrent_block(tbp, CFG, x[1], tst)
        _close(y, jy, msg=f"S={S} out")
        _close(tst["conv"], jst["conv"], msg=f"S={S} conv state")
        _close(tst["h"], jst["h"], STATE_TOL, msg=f"S={S} h")


# ---------------------------------------------------------------------------
# the slice as a whole vs JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jrglru.init(jax.random.PRNGKey(7), JCFG)


def _port_model(jparams, cfg):
    model = rglru.init(cfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(jparams, cfg, device="cpu"))
    return model


def _sure_rows(logits, tol):
    """Rows whose token the port must pick as JAX does: JAX's top-2
    margin exceeds twice the logit difference ``tol`` allows (each of the
    two logits may move by atol + rtol·|logit| towards the other)."""
    top = np.sort(_np(logits), axis=-1)
    allowed = tol["atol"] + tol["rtol"] * np.abs(top[:, -2:]).max(-1)
    return top[:, -1] - top[:, -2] > 2 * allowed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_slice_matches_jax(jparams, dtype):
    jcfg = dataclasses.replace(JCFG, dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    tol = SLICE_TOL if dtype == "float32" else BF16_TOL
    model = _port_model(jparams, cfg)
    jmodel = jrglru
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    max_len = PROMPT + GEN
    jlast, jc = jax.jit(jsteps.make_prefill_step(jcfg))(
        jparams, jmodel.init_cache(jcfg, B, max_len),
        {"tokens": jnp.asarray(prompts)})
    last, c = steps.make_prefill_step(cfg)(
        model, rglru.init_cache(cfg, B, max_len, device="cpu"),
        {"tokens": torch.from_numpy(prompts)})
    assert last.shape == (B, 1, cfg.vocab_size) and last.dtype == L.dtype_of(dtype)
    _close(last, jlast, tol, "prefill logits")

    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    jlogits = jax.jit(lambda p, c, t, i: jmodel.forward(
        p, jcfg, t, caches=c, cache_index=i)[0])
    decode = steps.make_decode_step(cfg)
    tok = np.asarray(jnp.argmax(jlast[:, -1], -1), np.int32)[:, None]
    checked = 0
    for i in range(GEN):
        idx = PROMPT + i
        want = jlogits(jparams, jc, jnp.asarray(tok), jnp.int32(idx))
        with torch.no_grad():
            got, _, _ = rglru.forward(model, cfg, torch.tensor(tok),
                                      caches=c, cache_index=idx)
        _close(got, want, tol, f"decode step {i} logits")
        jn, jc = jdecode(jparams, jc, {"tokens": jnp.asarray(tok),
                                       "cache_index": jnp.int32(idx)})
        n, c = decode(model, c, {"tokens": torch.tensor(tok),
                                 "cache_index": idx})
        sure = _sure_rows(want[:, -1], tol)
        assert np.array_equal(n.numpy()[sure], np.asarray(jn)[sure]), i
        checked += int(sure.sum())
        tok = np.asarray(jn, np.int32)
    assert checked > 0, "no decode step had a token sure within tol"


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def _random_model(cfg, seed=0):
    return rglru.init(cfg, generator=torch.Generator().manual_seed(seed),
                      device="cpu")


def test_decode_matches_full_forward():
    """Prefill + one decode step through the caches == the full forward at
    the last position (prompt longer than the window)."""
    cfg = CFG
    model = _random_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (B, 70),
                         generator=torch.Generator().manual_seed(1))
    caches = rglru.init_cache(cfg, B, 80, device="cpu")
    last, caches = steps.make_prefill_step(cfg)(model, caches,
                                                {"tokens": toks})
    nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
    with torch.no_grad():
        lg2, _, _ = rglru.forward(model, cfg, nxt, caches=caches,
                                  cache_index=70)
        full, _, _ = rglru.forward(model, cfg, torch.cat([toks, nxt], 1))
        _close(last[:, 0], full[:, -2], SLICE_TOL, "prefill vs full")
    _close(lg2[:, 0], full[:, -1], SLICE_TOL, "decode vs full")


def test_load_time_cast_is_bit_equal():
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    plain, cast = _random_model(cfg), _random_model(cfg)
    rglru.cast_for_serving(cast, cfg)
    for name, p in cast.named_parameters():
        f32 = name.endswith("norm") or ".rglru." in name
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    toks = torch.randint(0, cfg.vocab_size, (B, 70),
                         generator=torch.Generator().manual_seed(2))
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    outs = []
    for model in (plain, cast):
        c = rglru.init_cache(cfg, B, 73, device="cpu")
        last, c = prefill(model, c, {"tokens": toks})
        seq = [last]
        nxt = torch.argmax(last[:, -1], -1).to(torch.int32)[:, None]
        for i in range(2):
            nxt, c = decode(model, c, {"tokens": nxt, "cache_index": 70 + i})
            seq.append(nxt)
        outs.append(seq)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "encdec", "vlm"])
def test_get_model_refuses_unported_families(family):
    """Every family the JAX ``get_model`` resolves resolves: ``dense``,
    ``moe`` and ``vlm`` to the transformer, ``ssm`` to xLSTM, ``encdec``
    to the encoder-decoder; an unknown family is refused by name."""
    cfg = dataclasses.replace(CFG, family=family)
    m = {"ssm": xlstm, "encdec": encdec}.get(family, transformer)
    assert get_model(cfg).init is m.init
    assert get_model(cfg).cast_for_serving is m.cast_for_serving
    assert get_model(cfg).stack_params is m.stack_params
    assert get_model(CFG).init is rglru.init
    assert get_model(get_arch("paper-dqn")).init_cache is None
    with pytest.raises(ValueError, match="unknown family 'mamba'"):
        get_model(dataclasses.replace(CFG, family="mamba"))


@pytest.mark.parametrize("change,module", [
    (dict(use_qk_norm=True), L.Attention),
    (dict(mlp_kind="plain"), L.Mlp),
    (dict(act="silu"), L.Mlp),
])
def test_unported_layer_options_raise(change, module):
    """The options recurrentgemma-9b does not set, once refused, now build
    and match the JAX layers on the same params and inputs: q/k norms
    (nonzero weights) before RoPE, the plain MLP with biases, SiLU."""
    jcfg, cfg = (dataclasses.replace(c, **change) for c in (JCFG, CFG))
    rng = np.random.default_rng(12)
    if module is L.Attention:
        jp = dict(jL.init_attention(jax.random.PRNGKey(3), jcfg))
        for n in ("q_norm", "k_norm"):
            jp[n] = jnp.asarray(rng.standard_normal(jp[n].shape), jnp.float32)
    else:
        jp = dict(jL.init_mlp(jax.random.PRNGKey(3), jcfg))
        for n in ("b_up", "b_down"):
            if n in jp:
                jp[n] = jnp.asarray(rng.standard_normal(jp[n].shape),
                                    jnp.float32)
    tp = module(cfg, device="cpu")
    assert set(tp.state_dict()) == set(jp)
    tp.load_state_dict(params_from_numpy(jp, device="cpu"))
    S = 20
    x = _x(rng, B, S, cfg.d_model)
    if module is L.Attention:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        want, _ = jL.attention_block(jp, jcfg, x[0], jnp.asarray(pos),
                                     window=cfg.sliding_window)
        with torch.no_grad():
            got, _ = L.attention_block(tp, cfg, x[1], torch.from_numpy(pos),
                                       window=cfg.sliding_window)
    else:
        want = jL.mlp_block(jp, jcfg, x[0])
        with torch.no_grad():
            got = L.mlp_block(tp, cfg, x[1])
    _close(got, want)


CONFIG_CASES = [(name, cut) for name in (
    "recurrentgemma-9b", "h2o-danube-3-4b", "stablelm-3b", "granite-8b",
    "deepseek-7b", "mixtral-8x7b", "qwen2-moe-a2.7b", "chameleon-34b")
    for cut in (None, 5)] + [("paper-dqn", None)]


@pytest.mark.parametrize("name,cut", CONFIG_CASES)
def test_config_equals_jax_field_by_field(name, cut):
    ours, theirs = get_arch(name), jget_arch(name)
    if cut is not None:
        ours, theirs = reduced(ours, num_layers=cut), jreduced(theirs,
                                                               num_layers=cut)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    assert ours.head_dim_ == theirs.head_dim_
    assert ours.q_per_kv == theirs.q_per_kv


@pytest.mark.parametrize("num_layers", [5, 7])
def test_convert_unstacks_periods_in_layer_order(num_layers):
    """5 layers: one period + a remainder of two; 7: two periods + one."""
    jcfg = jreduced(jget_arch(ARCH), num_layers=num_layers)
    cfg = reduced(get_arch(ARCH), num_layers=num_layers)
    jp = jrglru.init(jax.random.PRNGKey(9), jcfg)
    flat = lm_params_from_numpy(jp, cfg, device="cpu")
    model = rglru.init(cfg, device="cpu")
    assert set(flat) == set(model.state_dict())
    model.load_state_dict(flat)
    pat = len(cfg.rglru.block_pattern)
    n_full = num_layers // pat
    for layer in range(num_layers):
        if layer < n_full * pat:
            src = jax.tree.map(lambda a: a[layer // pat],
                               jp["periods"][layer % pat])
        else:
            src = jp["rem"][layer - n_full * pat]
        for name, t in params_from_numpy(src, device="cpu").items():
            assert torch.equal(model.state_dict()[f"blocks.{layer}.{name}"],
                               t), (layer, name)
    for name in ("embed", "final_norm", "unembed"):
        assert torch.equal(model.state_dict()[name],
                           torch.from_numpy(np.array(jp[name])))


def test_serve_runs_on_cpu():
    """The entry point end to end on the CPU: the wrappers run their plain
    versions there, so no kernel is launched."""
    cfg = reduced(get_arch(ARCH), num_layers=3)
    res = serve(cfg, batch=B, prompt_len=70, gen=3, device="cpu",
                verbose=False)
    assert res.tokens.shape == (B, 3) and res.tokens.dtype == torch.int32
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
    assert bool(torch.isfinite(res.last_logits).all())
    assert res.launches == {p: {"rglru_scan": 0, "flash_attention": 0}
                            for p in ("prefill", "decode")}


NEW_MODULES = ["configs/recurrentgemma_9b.py", "models/rglru.py",
               "models/api.py", "launch/steps.py", "launch/serve.py",
               "kernels/ops.py", "kernels/ref.py", "models/layers.py",
               "convert.py", "configs/base.py", "configs/__init__.py",
               "configs/h2o_danube_3_4b.py", "configs/stablelm_3b.py",
               "configs/granite_8b.py", "configs/deepseek_7b.py",
               "configs/mixtral_8x7b.py", "configs/qwen2_moe_a2_7b.py",
               "configs/chameleon_34b.py", "models/moe.py",
               "models/transformer.py", "launch/serve_lm.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_serving_modules_import_neither_jax_nor_the_jax_package(rel):
    tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                             for n in names), names
