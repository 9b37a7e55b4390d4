"""The port's gradients against the JAX package, on the same numpy-made
inputs and on JAX parameters carried across by ``repro_torch.convert``:

* the B4/B3 autograd Functions (``kernels/ops.py``) on the CPU: backward
  ``==`` autograd through the plain version, ``gradcheck`` and
  ``gradgradcheck`` in f64, ``torch.func.vmap(grad)`` equal to a loop
  (rtol 1e-6);
* ``lm_loss`` gradients against ``jax.grad`` of the reference for reduced
  granite (GQA), stablelm (MHA), danube (SWA) and qwen2-moe (aux loss), in
  f32: within 1e-4 of each leaf's largest gradient;
* ``cfg.remat`` (recompute per block) gives the same loss and gradient,
  and the modules' params are trainable and stack into the JAX leaves.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402

# f32 gradients of a whole model: the same ops, sums in another order
GRAD_RTOL = 1e-4
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these small models run about as fast on one,
    and in a parallel test run (a worker per core) more threads per
    worker oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0, **change):
    """The reduced config in both packages (with ``change``), the JAX
    params and the port's stacked-param dict of the same numbers."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), **change)
    cfg = dataclasses.replace(reduced(get_arch(arch)), **change)
    jp = jtransformer.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, params_from_numpy(jp, device="cpu")


def _tokens(cfg, shape, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., ::5] = -1
    return toks, labels


def _grads_close(got, jtree, rtol=GRAD_RTOL):
    want = params_from_numpy(jtree, device="cpu")
    assert set(got) == set(want)
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k].float() - want[k]).abs().max())
        assert err <= rtol * max(scale, 1e-30), (k, err, scale)


# ---------------------------------------------------------------------------
# the B4 / B3 autograd Functions
# ---------------------------------------------------------------------------

ATTN_CASES = [dict(causal=True, window=0, softcap=0.0),
              dict(causal=True, window=5, softcap=0.0),
              dict(causal=True, window=0, softcap=3.0),
              dict(causal=False, window=0, softcap=0.0)]


def _qkv(dtype=torch.float32, B=2, S=12, H=4, K=2, hd=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]


@pytest.mark.parametrize("kw", ATTN_CASES)
def test_flash_attention_backward_equals_plain_autograd(kw):
    q, k, v = (t.requires_grad_() for t in _qkv())
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad((ops.flash_attention(q, k, v, **kw) * w).sum(),
                              (q, k, v))
    want = torch.autograd.grad(
        (ref.attention_reference(q, k, v, **kw) * w).sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw", ATTN_CASES)
def test_flash_attention_function_gradcheck_f64(kw):
    args = (*(t.to(F64).requires_grad_() for t in _qkv(B=1, S=6, H=2, K=1,
                                                        hd=4)),
            kw["causal"], kw["window"], kw["softcap"])
    assert torch.autograd.gradcheck(ops._FlashAttention.apply, args)
    # the backward is differentiable operations of the plain version, so a
    # second derivative is the plain version's (never a silent zero)
    assert torch.autograd.gradgradcheck(ops._FlashAttention.apply, args)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_function_gradcheck_and_backward(with_h0):
    g = torch.Generator().manual_seed(0)
    log_a = (-torch.rand(2, 6, 3, generator=g) * 0.5).to(F64)
    b = torch.randn(2, 6, 3, generator=g).to(F64)
    h0 = torch.randn(2, 3, generator=g).to(F64) if with_h0 else None
    args = [log_a.requires_grad_(), b.requires_grad_(),
            None if h0 is None else h0.requires_grad_()]
    assert torch.autograd.gradcheck(ops._RglruScan.apply, tuple(args))
    assert torch.autograd.gradgradcheck(ops._RglruScan.apply, tuple(args))
    la, bb = log_a.detach().float().requires_grad_(), \
        b.detach().float().requires_grad_()
    h = None if h0 is None else h0.detach().float()
    got = torch.autograd.grad(
        sum(x.square().sum() for x in ops.rglru_scan(la, bb, h)), (la, bb))
    want = torch.autograd.grad(
        sum(x.square().sum() for x in ref.rglru_scan_reference(la, bb, h)),
        (la, bb))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("q_only", [True, False])
def test_flash_attention_vmap_grad_equals_loop(q_only):
    """``torch.func.vmap(grad)`` over a leading axis of 3 (q alone mapped,
    or q, k, v all mapped) equals a loop of ``grad``: the Function's vmap
    rule folds the axis into the batch."""
    q, k, v = _qkv()
    g = torch.Generator().manual_seed(5)
    qs = torch.randn((3,) + q.shape, generator=g)
    ks = torch.randn((3,) + k.shape, generator=g)
    vs = torch.randn((3,) + v.shape, generator=g)

    def f(q, k, v):
        return ops.flash_attention(q, k, v, window=5).square().sum()

    if q_only:
        got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)),
                              in_dims=(0, None, None))(qs, k, v)
        want = [torch.func.grad(f, argnums=(0, 1, 2))(qs[i], k, v)
                for i in range(3)]
    else:
        got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(
            qs, ks, vs)
        want = [torch.func.grad(f, argnums=(0, 1, 2))(qs[i], ks[i], vs[i])
                for i in range(3)]
    for j in range(3):
        torch.testing.assert_close(got[j], torch.stack([w[j] for w in want]),
                                   rtol=1e-6, atol=1e-6)


def test_rglru_scan_vmap_grad_equals_loop():
    g = torch.Generator().manual_seed(2)
    las = -torch.rand(3, 2, 6, 4, generator=g) * 0.5
    b = torch.randn(2, 6, 4, generator=g)
    h0s = torch.randn(3, 2, 4, generator=g)

    def f(la, b, h0):
        h, last = ops.rglru_scan(la, b, h0)
        return h.square().sum() + last.sum()

    gf = torch.func.grad(f, argnums=(0, 1, 2))
    got = torch.func.vmap(gf, in_dims=(0, None, 0))(las, b, h0s)
    want = [gf(las[i], b, h0s[i]) for i in range(3)]
    for j in range(3):
        torch.testing.assert_close(got[j], torch.stack([w[j] for w in want]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# lm_loss gradients and the train step
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "granite-8b": dict(num_kv_heads=2),     # GQA 4/2 (reduced gives MHA)
    "stablelm-3b": {},                      # MHA
    "h2o-danube-3-4b": {},                  # SWA, window 64 < S = 80
    "qwen2-moe-a2.7b": {},                  # MoE aux loss
}


@pytest.mark.parametrize("arch", sorted(LOSS_CASES))
def test_lm_loss_gradients_match_jax_grad(arch):
    jcfg, cfg, jp, p = _pair(arch, **LOSS_CASES[arch])
    toks, labels = _tokens(cfg, (2, 80))
    jl, jg = jax.value_and_grad(lambda p: japi.lm_loss(
        p, jcfg, jnp.asarray(toks), jnp.asarray(labels)))(jp)
    g, l = torch.func.grad_and_value(lambda p: api.lm_loss(
        p, cfg, torch.from_numpy(toks), torch.from_numpy(labels)))(p)
    np.testing.assert_allclose(float(l), float(jl), rtol=1e-5)
    _grads_close(g, jg)
    if cfg.moe is not None:
        # the aux loss alone (every label masked) has its own gradient
        none = np.full_like(labels, -1)
        _, ja = jax.value_and_grad(lambda p: japi.lm_loss(
            p, jcfg, jnp.asarray(toks), jnp.asarray(none)))(jp)
        ga = torch.func.grad(lambda p: api.lm_loss(
            p, cfg, torch.from_numpy(toks), torch.from_numpy(none)))(p)
        assert float(ga["blocks.mlp.router"].abs().max()) > 0
        _grads_close(ga, ja)


def test_remat_gives_the_same_gradient():
    """``cfg.remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``): the same loss and gradient."""
    cfg = dataclasses.replace(reduced(get_arch("granite-8b"), d_model=64),
                              num_kv_heads=2)
    p = train.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks, labels = (torch.from_numpy(a) for a in _tokens(cfg, (2, 24)))
    loss = lambda c: (lambda q: api.lm_loss(q, c, toks, labels))  # noqa
    l0, g0 = steps.value_and_grad(loss(cfg), p)
    l1, g1 = steps.value_and_grad(
        loss(dataclasses.replace(cfg, remat=True)), p)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_module_params_are_trainable_and_stack_to_the_jax_leaves():
    cfg = reduced(get_arch("granite-8b"), num_layers=3)
    model = transformer.init(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    stacked = transformer.stack_params(model)
    assert len(stacked) == 12                      # the JAX tree's leaves
    assert stacked["blocks.attn.wq"].shape == (3,) + tuple(
        model.blocks[0].attn.wq.shape)
    toks = torch.from_numpy(_tokens(cfg, (1, 9))[0])
    with torch.no_grad():
        a = transformer.forward(model, cfg, toks)[0]
        b = transformer.forward(stacked, cfg, toks)[0]
    assert torch.equal(a, b)
