"""The plain versions of the two backward kernels (B3′, B4′) on the CPU:

* ``ref.rglru_scan_backward_reference`` ``==`` autograd through
  ``ref.rglru_scan_reference`` in f32 and bf16, with and without h0 and
  g_last;
* ``ref.attention_backward_reference`` against autograd through
  ``ref.attention_reference`` (causal, window, softcap, GQA / MQA,
  S ≠ T, head_dim 120): f32 within 1e-5 of each gradient's largest
  entry; bf16 each route within one bf16 rounding (2^-7) of that entry
  of the f64 gradient at the same bf16 inputs;
* both against ``jax.vjp`` of the JAX package's ``repro.models.rglru.
  rglru_scan`` and ``repro.kernels.ref.mha_reference`` on the same
  numpy-made inputs, in f32 (the scan also at the T that cut B3′'s
  chunks raggedly: T = 1, L, S·L ± 1, two laps and a ragged third);
* the wrappers ``ops.rglru_scan_backward`` / ``ops.flash_attention_
  backward`` on the CPU (their plain versions), their Functions' own
  backward (``gradcheck`` in f64: the second derivative of the plain
  version) and ``vmap`` rule;
* the LM kernels' CPU gradients are still autograd's through the plain
  forwards, bit for bit;
* on ``meta`` the backward reports its work and launches nothing, and the
  two counters are counted kernels;
* B4′'s dk/dv grid: the keys a block holds by dtype and head_dim, and
  the split of a kv head's query heads over blocks by that tile.

The kernels themselves are held to these plain versions on the card by
the ``gpu`` tests of ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.core import scanloop  # noqa: E402
from repro_torch.kernels import ops, ref, work  # noqa: E402

F64 = torch.float64
#: f32 plain backward vs autograd: the same products, D summed over the
#: row in another order (measured: at most 1.3e-6 of the largest entry)
F32_REL = 1e-5
#: bf16: one bf16 rounding of the largest entry (both routes, against the
#: f64 gradient at the same bf16 inputs; measured 4.5e-3 / 4.7e-3)
BF16_REL = 2.0 ** -7
#: f32 against the JAX package (its associative scan and einsum attention
#: sum in other orders)
JAX_REL = 1e-5

ATTN_CASES = [
    # (B, S, H, K, T, hd), masks
    ((2, 12, 4, 2, 12, 8), dict(causal=True, window=0, softcap=0.0)),
    ((2, 12, 4, 2, 12, 8), dict(causal=True, window=5, softcap=0.0)),
    ((1, 9, 4, 1, 9, 120), dict(causal=True, window=0, softcap=3.0)),
    ((2, 5, 2, 2, 11, 16), dict(causal=False, window=0, softcap=0.0)),
    ((1, 33, 6, 3, 33, 64), dict(causal=True, window=7, softcap=2.0)),
    ((1, 20, 4, 1, 20, 32), dict(causal=False, window=6, softcap=0.0)),
]


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-30)


def _scan_inputs(dtype, with_h0, with_last, B=2, T=23, W=5, seed=0):
    rng = np.random.default_rng(seed)
    la = torch.from_numpy(-rng.random((B, T, W)).astype(np.float32) * 0.5)
    b = torch.from_numpy(rng.standard_normal((B, T, W)).astype(np.float32))
    h0 = (torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
          if with_h0 else None)
    g = torch.from_numpy(rng.standard_normal((B, T, W)).astype(np.float32))
    gl = (torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
          if with_last else None)
    return la.to(dtype), b.to(dtype), h0, g.to(dtype), gl


@pytest.mark.parametrize("dtype,with_h0,with_last", list(itertools.product(
    [torch.float32, torch.bfloat16], [False, True], [False, True])))
def test_rglru_scan_backward_reference_equals_autograd(dtype, with_h0,
                                                       with_last):
    la, b, h0, g, gl = _scan_inputs(dtype, with_h0, with_last)
    ins = [la.requires_grad_(), b.requires_grad_()]
    if h0 is not None:
        ins.append(h0.requires_grad_())
    h, last = ref.rglru_scan_reference(*ins)
    outs, cots = [h], [g]
    if gl is not None:
        outs.append(last)
        cots.append(gl)
    want = torch.autograd.grad(outs, ins, cots)
    got = ref.rglru_scan_backward_reference(
        la.detach(), b.detach(), None if h0 is None else h0.detach(),
        h.detach(), g, gl)
    assert got[0].dtype == got[1].dtype == dtype
    assert got[2].dtype == torch.float32 and got[2].shape == (2, 5)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # the wrapper on CPU tensors is the plain version
    wrapped = ops.rglru_scan_backward(
        la.detach(), b.detach(), None if h0 is None else h0.detach(),
        h.detach(), g, gl)
    assert (wrapped[2] is None) == (h0 is None)
    for x, y in zip(wrapped, got):
        if x is not None:
            assert torch.equal(x, y)


def _attn_inputs(shape, dtype, seed):
    B, S, H, K, T, hd = shape
    rng = np.random.default_rng(seed)

    def r(*s, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(s) * scale).astype(np.float32)).to(dtype)

    return (r(B, S, H, hd, scale=2.0), r(B, T, K, hd), r(B, T, K, hd),
            r(B, S, H, hd))


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_reference_within_autograd(case, dtype):
    shape, kw = ATTN_CASES[case]
    q, k, v, g = _attn_inputs(shape, dtype, seed=case)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_reference(*ins, **kw), ins, g)
    got = ref.attention_backward_reference(q, k, v, g, **kw)
    wrapped = ops.flash_attention_backward(q, k, v, g, **kw)
    for x, y, w in zip(got, want, wrapped):
        assert x.dtype == dtype and x.shape == y.shape
        assert torch.equal(x, w)
    if dtype == torch.float32:
        assert max(_rel(x, y) for x, y in zip(got, want)) <= F32_REL
        return
    ins64 = [t.to(F64).requires_grad_() for t in (q, k, v)]
    exact = torch.autograd.grad(ref.attention_reference(*ins64, **kw),
                                ins64, g.to(F64))
    for route in (got, want):
        assert max(_rel(x, e) for x, e in zip(route, exact)) <= BF16_REL


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_backward_matches_jax_vjp(with_h0, T=40):
    la, b, h0, g, gl = _scan_inputs(torch.float32, with_h0, True, T=T,
                                    W=7, seed=3)
    h, _ = ref.rglru_scan_reference(la, b, h0)
    got = ref.rglru_scan_backward_reference(la, b, h0, h, g, gl)
    prim = [jnp.asarray(t.numpy()) for t in (la, b)]
    if with_h0:
        prim.append(jnp.asarray(h0.numpy()))
    _, pull = jax.vjp(jrglru.rglru_scan, *prim)
    want = pull((jnp.asarray(g.numpy()), jnp.asarray(gl.numpy())))
    for x, y in zip(got, want):
        assert _rel(x, torch.from_numpy(np.asarray(y))) <= JAX_REL


#: B3′'s chunk and cluster (64 steps, 8 CTAs): T = 1, T = L, T = S·L ± 1,
#: two laps and a ragged third
RAGGED_TS = [1, 64, 511, 513, 1024, 1101]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", RAGGED_TS)
def test_rglru_scan_backward_matches_jax_vjp_ragged_t(T, with_h0):
    """The same comparison at the T that cut B3′'s chunks and laps
    raggedly (``ops._rglru_scan_backward_plan``)."""
    assert ops.B3P_STEPS == 64 and ops.B3P_CLUSTER == 8
    test_rglru_scan_backward_matches_jax_vjp(with_h0, T=T)


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attention_backward_matches_jax_vjp(case):
    shape, kw = ATTN_CASES[case]
    q, k, v, g = _attn_inputs(shape, torch.float32, seed=10 + case)
    got = ref.attention_backward_reference(q, k, v, g, **kw)
    _, pull = jax.vjp(lambda q, k, v: jref.mha_reference(q, k, v, **kw),
                      *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = pull(jnp.asarray(g.numpy()))
    for x, y in zip(got, want):
        assert _rel(x, torch.from_numpy(np.asarray(y))) <= JAX_REL


def test_cpu_gradients_are_autograd_through_the_plain_forwards():
    """The forward Functions' backward on CPU tensors is autograd's VJP of
    the plain versions, bit for bit (bf16, GQA, softcap, g_last)."""
    q, k, v, g = _attn_inputs((2, 10, 4, 2, 10, 16), torch.bfloat16, 1)
    kw = dict(causal=True, window=4, softcap=2.0)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*ins, **kw), ins, g)
    want = torch.autograd.grad(ref.attention_reference(*ins, **kw), ins, g)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    la, b, h0, gh, gl = _scan_inputs(torch.bfloat16, True, True)
    ins = [la.requires_grad_(), b.requires_grad_(), h0.requires_grad_()]
    got = torch.autograd.grad(ops.rglru_scan(*ins), ins, (gh, gl))
    want = torch.autograd.grad(ref.rglru_scan_reference(*ins), ins, (gh, gl))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_backward_function_gradcheck_f64(with_h0):
    """The backward Function's own backward is the VJP of the plain VJP:
    gradcheck against finite differences of the plain backward, with the
    forward's output h (which the Function takes as given) recomputed from
    the perturbed inputs."""
    la, b, h0, g, gl = (None if t is None else t.to(F64) for t in
                        _scan_inputs(torch.float32, with_h0, True, B=1, T=5,
                                     W=3))

    def f(la, b, g, gl, *h0):
        h0 = h0[0] if h0 else None
        h, _ = ref.rglru_scan_reference(la, b, h0)
        return ops._RglruScanBackward.apply(la, b, h0, h, g,
                                            gl)[:2 + len(h0s)]

    h0s = () if h0 is None else (h0.requires_grad_(),)
    assert torch.autograd.gradcheck(
        f, (la.requires_grad_(), b.requires_grad_(), g.requires_grad_(),
            gl.requires_grad_(), *h0s))


@pytest.mark.parametrize("case", [1, 2])
def test_flash_attention_backward_function_gradcheck_f64(case):
    shape, kw = ATTN_CASES[case]
    B, S, H, K, T, _ = shape
    q, k, v, g = (t.to(F64).requires_grad_() for t in _attn_inputs(
        (1, min(S, 5), H, K, min(T, 5), 4), torch.float32, seed=case))
    assert torch.autograd.gradcheck(
        lambda q, k, v, g: ops._FlashAttentionBackward.apply(
            q, k, v, g, kw["causal"], kw["window"], kw["softcap"]),
        (q, k, v, g))


def test_backward_functions_vmap_fold_the_mapped_axis():
    """``torch.func.vmap`` of each backward wrapper equals a loop."""
    shape, kw = ATTN_CASES[1]
    qs, ks, vs, gs = zip(*(_attn_inputs(shape, torch.float32, seed=s)
                           for s in range(3)))
    qs, ks, vs, gs = (torch.stack(t) for t in (qs, ks, vs, gs))
    got = torch.func.vmap(lambda q, k, v, g: ops.flash_attention_backward(
        q, k, v, g, **kw), in_dims=(0, None, None, 0))(qs, ks[0], vs[0], gs)
    for i in range(3):
        want = ref.attention_backward_reference(qs[i], ks[0], vs[0], gs[i],
                                                **kw)
        for j in range(3):
            torch.testing.assert_close(got[j][i], want[j], rtol=1e-6,
                                       atol=1e-6)
    las, bs, h0s, ghs, gls = zip(*(_scan_inputs(torch.float32, True, True,
                                                seed=s) for s in range(3)))
    las, bs, h0s, ghs, gls = (torch.stack(t) for t in
                              (las, bs, h0s, ghs, gls))
    hs = torch.stack([ref.rglru_scan_reference(las[i], bs[i], h0s[i])[0]
                      for i in range(3)])
    got = torch.func.vmap(ops.rglru_scan_backward)(las, bs, h0s, hs, ghs,
                                                   gls)
    for i in range(3):
        want = ref.rglru_scan_backward_reference(las[i], bs[i], h0s[i],
                                                 hs[i], ghs[i], gls[i])
        for j in range(3):
            torch.testing.assert_close(got[j][i], want[j], rtol=1e-6,
                                       atol=1e-6)


def test_backward_on_meta_reports_work_and_launches_nothing():
    seen = []
    names = scanloop.COUNTED_KERNELS
    before = scanloop.launch_counts()
    q = torch.empty(2, 8, 4, 16, device="meta", requires_grad=True)
    k = torch.empty(2, 8, 2, 16, device="meta", requires_grad=True)
    la = torch.empty(2, 8, 6, device="meta", requires_grad=True)
    b = torch.empty(2, 8, 6, device="meta", requires_grad=True)
    with work.counting(lambda *a: seen.append(a)):
        out = ops.flash_attention(q, k, k, causal=True, window=4)
        h, last = ops.rglru_scan(la, b)
        grads = torch.autograd.grad(out.sum() + h.sum() + last.sum(),
                                    (q, k, la, b))
    assert scanloop.launch_counts() == before
    assert [g.shape for g in grads] == [q.shape, k.shape, la.shape, b.shape]
    assert all(g.device.type == "meta" for g in grads)
    nb, fl = work.flash_attention_backward(2, 8, 8, 4, 2, 16, causal=True,
                                           window=4, elem=4)
    sb, sf = work.rglru_scan_backward(2, 8, 6, with_h0=False,
                                      with_g_last=True, elem=4)
    backward = [s for s in seen if s[0].endswith("_backward")]
    assert sorted(backward) == sorted([("flash_attention_backward", fl, nb),
                                       ("rglru_scan_backward", sf, sb)])
    assert {"rglru_scan_backward", "flash_attention_backward"} <= set(names)


def test_backward_work_counts():
    # 5 elem-sized arrays per element, h0 / g_last / dh0 f32 rows
    assert work.rglru_scan_backward(2, 3, 4, with_h0=True, with_g_last=False,
                                    elem=2) == (10 * 24 + 8 * 8, 5 * 24)
    # q, g, dq and k, v, dk, dv; lse and D; 10·hd per visible pair
    assert work.flash_attention_backward(1, 4, 4, 2, 1, 8, causal=True,
                                         window=0, elem=2) == (
        2 * (3 * 4 * 2 * 8 + 4 * 4 * 8) + 8 * 2 * 4, 10 * 8 * 10 * 2)
    counts = scanloop.launch_counts()
    assert counts["rglru_scan_backward"] == ops.rglru_scan_backward.launches
    assert counts["flash_attention_backward"] == \
        ops.flash_attention_backward.launches


@pytest.mark.parametrize("dtype,hd,tile", [
    (torch.float32, 128, 64), (torch.float32, 256, 64),
    (torch.bfloat16, 36, 128), (torch.bfloat16, 120, 128),
    (torch.bfloat16, 128, 128), (torch.bfloat16, 256, 64)])
def test_bwd_key_tile(dtype, hd, tile):
    """Keys a block of B4′'s dk/dv pass holds: 64 on the f32 kernel; on
    the bf16 one 128 (two consumers of 64), 64 where head_dim > 128 (the
    consumers split head_dim)."""
    assert ops._bwd_key_tile(dtype, hd) == tile


@pytest.mark.parametrize("B,T,K,group,tile,splits", [
    (2, 1500, 20, 1, 128, 1),    # whisper's encoder: the kv tiles fill
    (4, 4096, 8, 4, 128, 1),     # 1024 blocks: no split
    (4, 512, 8, 4, 128, 2),      # granite, bf16: 128 blocks, 2 heads a split
    (4, 512, 8, 4, 64, 2),       # granite, f32: 256 blocks
    (2, 512, 1, 16, 64, 16),     # the hybrid's MQA: every head its own
    (2, 1024, 4, 4, 64, 2),      # the tile changes the split:
    (2, 1024, 4, 4, 128, 4),     # 128 blocks vs 64
])
def test_bwd_head_splits(B, T, K, group, tile, splits):
    """B4′'s dk/dv head split by the key tile: 1 where the kv tiles alone
    reach ``_BWD_MIN_BLOCKS``; else enough splits to reach it (an equal
    share of heads each), never more than ``group``; within the grid's z
    limit."""
    got = ops._bwd_head_splits(B, T, K, group, tile)
    assert got == splits
    blocks = -(-T // tile) * K * B
    assert 1 <= got <= group and B * got <= ops._GRID_YZ
    if blocks >= ops._BWD_MIN_BLOCKS:
        assert got == 1
    else:
        # no more splits than reach the goal
        assert got <= min(group, -(-ops._BWD_MIN_BLOCKS // blocks))


def test_bwd_head_splits_stay_in_the_grid():
    """Over a sweep of shapes the split never exceeds the group or the
    grid's z limit, and is 1 wherever the kv tiles alone fill the card."""
    for B, T, K, group, tile in itertools.product(
            (1, 3, 200, 70000), (1, 64, 1500), (1, 8), (1, 4, 16, 1000),
            (64, 128)):
        got = ops._bwd_head_splits(B, T, K, group, tile)
        assert 1 <= got <= max(group, 1)
        assert B * got <= max(ops._GRID_YZ, B)
        if -(-T // tile) * K * B >= ops._BWD_MIN_BLOCKS:
            assert got == 1
