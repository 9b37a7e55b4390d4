"""The port's RG-LRU scan and flash-attention kernels against the JAX
package: the port's plain versions (what its wrappers run on CPU tensors)
against ``repro.kernels.ops.*(impl="interpret")``, the JAX oracles in
``repro.kernels.ref`` and, for the scan, the JAX model's associative scan,
on the same numpy inputs made from a seed. The CUDA kernels themselves
are held to the plain versions on the card by the ``gpu`` tests in
``test_torch_kernels.py`` and by ``chip_smoke.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# f32 against the JAX oracle: the same algorithm, sums in another order
F32_REF_TOL = dict(rtol=1e-5, atol=1e-5)
# f32 against the interpret-mode Pallas kernel: online softmax against the
# oracle's one-pass softmax (the JAX package's own tolerance,
# tests/test_kernels.py:15)
F32_KERNEL_TOL = dict(rtol=2e-3, atol=2e-3)
# bf16: outputs rounded to bf16 at different points (tests/test_kernels.py:16)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)

ATTN_CASES = [
    # B, S, H, K, hd, causal, window, softcap: the JAX test grid
    # (tests/test_kernels.py:19-26) and an MQA + window + softcap case
    # shaped like recurrentgemma's attention, with S longer than the window
    (2, 128, 4, 2, 64, True, 0, 0.0),
    (1, 256, 4, 4, 64, True, 0, 0.0),
    (2, 128, 4, 1, 64, True, 64, 0.0),
    (1, 96, 2, 2, 32, True, 0, 0.0),
    (1, 128, 4, 2, 128, False, 0, 0.0),
    (1, 64, 8, 2, 16, True, 32, 0.0),
    (1, 80, 4, 1, 64, True, 64, 30.0),
]


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor."""
    if dtype == "bfloat16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,softcap", ATTN_CASES)
def test_flash_attention_plain_matches_jax(B, S, H, K, hd, causal, window,
                                           softcap, dtype):
    rng = np.random.default_rng(S * 31 + H * 7 + hd)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, hd)
    oracle = jref.mha_reference(qj, kj, vj, **kw)
    pallas = jops.flash_attention(qj, kj, vj, impl="interpret", block_q=64,
                                  block_k=64, **kw)
    f32 = dtype == "float32"
    np.testing.assert_allclose(_np(got), _np(oracle),
                               **(F32_REF_TOL if f32 else BF16_TOL))
    np.testing.assert_allclose(_np(got), _np(pallas),
                               **(F32_KERNEL_TOL if f32 else BF16_TOL))


RGLRU_CASES = [(2, 64, 32, 16, 16), (1, 100, 48, 32, 32),   # ragged T and W
               (3, 256, 128, 128, 128)]


def _rglru_inputs(B, T, W):
    rng = np.random.default_rng(B * 1000 + T + W)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    log_a = -np.logaddexp(x, 0.0).astype(np.float32)          # -softplus
    b = rng.standard_normal((B, T, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return log_a, b, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,W,bt,bw", RGLRU_CASES)
def test_rglru_scan_plain_matches_jax(B, T, W, bt, bw, dtype):
    log_a, b, h0 = _rglru_inputs(B, T, W)
    (laj, lat), (bj, bt_) = _pair(log_a, dtype), _pair(b, dtype)
    h, h_last = ops.rglru_scan(lat, bt_, torch.from_numpy(h0))
    assert h.dtype == lat.dtype and h_last.dtype == torch.float32
    tol = F32_REF_TOL if dtype == "float32" else BF16_TOL
    want = [jref.rglru_scan_reference(laj, bj, jnp.asarray(h0)),
            jops.rglru_scan(laj, bj, jnp.asarray(h0), impl="interpret",
                            block_t=bt, block_w=bw)]
    if dtype == "float32":
        want.append(jrglru.rglru_scan(laj, bj, jnp.asarray(h0)))
    for wh, whl in want:
        np.testing.assert_allclose(_np(h), _np(wh), **tol)
        np.testing.assert_allclose(_np(h_last), _np(whl), **tol)


def test_rglru_scan_without_h0_starts_from_zero():
    log_a, b, _ = _rglru_inputs(2, 37, 20)
    h, h_last = ops.rglru_scan(torch.from_numpy(log_a), torch.from_numpy(b))
    wh, whl = jref.rglru_scan_reference(jnp.asarray(log_a), jnp.asarray(b))
    np.testing.assert_allclose(_np(h), _np(wh), **F32_REF_TOL)
    np.testing.assert_allclose(_np(h_last), _np(whl), **F32_REF_TOL)
    # the plain version steps in time order, one rounded op at a time
    hz = torch.zeros(2, 20)
    for t in range(37):
        hz = torch.exp(torch.from_numpy(log_a[:, t])) * hz \
            + torch.from_numpy(b[:, t])
    assert torch.equal(h_last, hz) and torch.equal(h[:, -1], hz)


# inputs the JAX wrappers refuse, each with the exception they raise
# (repro/kernels/ops.py:30-64); the port's wrappers raise the same
ATTN_BAD = [
    ("int dtype", (1, 8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16), "int32",
     TypeError),
    ("q not 4-d", (8, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16), "float32",
     ValueError),
    ("k, v shapes differ", (1, 8, 2, 16), (1, 8, 1, 16), (1, 9, 1, 16),
     "float32", ValueError),
    ("head_dim differs", (1, 8, 2, 16), (1, 8, 1, 8), (1, 8, 1, 8),
     "float32", ValueError),
    ("H % K", (1, 8, 2, 16), (1, 8, 3, 16), (1, 8, 3, 16), "float32",
     ValueError),
]


@pytest.mark.parametrize("what,sq,sk,sv,dtype,exc", ATTN_BAD,
                         ids=[c[0] for c in ATTN_BAD])
def test_flash_attention_guards_match_jax(what, sq, sk, sv, dtype, exc):
    q, k, v = (np.ones(s, dtype) for s in (sq, sk, sv))
    with pytest.raises(exc):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with pytest.raises(exc):
        ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))


RGLRU_BAD = [
    ("int dtype", (2, 4, 8), (2, 4, 8), "int32", TypeError),
    ("shapes differ", (2, 4, 8), (2, 4, 9), "float32", ValueError),
    ("not 3-d", (4, 8), (4, 8), "float32", ValueError),
]


@pytest.mark.parametrize("what,sa,sb,dtype,exc", RGLRU_BAD,
                         ids=[c[0] for c in RGLRU_BAD])
def test_rglru_scan_guards_match_jax(what, sa, sb, dtype, exc):
    la, b = np.ones(sa, dtype), np.ones(sb, dtype)
    with pytest.raises(exc):
        jops.rglru_scan(jnp.asarray(la), jnp.asarray(b))
    with pytest.raises(exc):
        ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(b))


class _OtherDevice(torch.Tensor):
    """A CPU tensor that reports a device the wrappers have no kernel for
    (``xpu``)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_lm_wrappers_have_no_fallback():
    """A tensor on a device with no kernel raises instead of falling back
    to the plain version; ``meta`` (the dry run) computes nothing and
    launches nothing; the launch counters do not move."""
    before = (ops.rglru_scan.launches, ops.flash_attention.launches)
    x = torch.zeros(1, 8, 2, 16).as_subclass(_OtherDevice)
    kv = torch.zeros(1, 8, 1, 16).as_subclass(_OtherDevice)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops.flash_attention(x, kv, kv)
    a = torch.zeros(1, 8, 16).as_subclass(_OtherDevice)
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops.rglru_scan(a, a)
    m = torch.zeros(1, 8, 16, device="meta")
    h, last = ops.rglru_scan(m, m)
    assert h.device.type == "meta" and last.shape == (1, 16)
    q = torch.zeros(1, 8, 2, 16, device="meta")
    assert ops.flash_attention(q, q[:, :, :1], q[:, :, :1]).shape == q.shape
    # mixed devices are refused too
    with pytest.raises(ValueError):
        ops.rglru_scan(torch.zeros(1, 8, 16), m)
    assert (ops.rglru_scan.launches, ops.flash_attention.launches) == before


def test_flash_attention_plain_is_the_model_reference():
    """B4's plain version is the model's decode attention:
    ``layers.attention_reference`` is ``ref.attention_reference``, and the
    CPU path of ``ops.flash_attention`` gives identical outputs."""
    from repro_torch.models import layers as L
    assert L.attention_reference is ref.attention_reference
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    for kw in (dict(causal=True, window=16, softcap=30.0),
               dict(causal=False, window=0, softcap=0.0)):
        assert torch.equal(ops.flash_attention(q, k, k, **kw),
                           ref.attention_reference(q, k, k, **kw))


def _layout_views():
    """q/k/v-shaped views the attention wrapper may hand its kernel, with
    whether the kernel can read each as it is (16-byte multiple strides,
    16-byte aligned base, unit head_dim stride)."""
    x = torch.zeros(2, 6, 4, 64, dtype=torch.bfloat16)
    wide = torch.zeros(2, 6, 4, 128, dtype=torch.bfloat16)
    heads = torch.zeros(2, 4, 6, 64, dtype=torch.bfloat16)
    flat = torch.zeros(2 * 6 * 4 * 64 + 1, dtype=torch.bfloat16)
    return {
        "contiguous": (x, True),
        "row slice": (wide[..., :64], True),
        "heads-major": (heads.transpose(1, 2), True),
        "expanded kv head": (x[:, :, :1].expand(2, 6, 4, 64), False),
        "unaligned base": (flat[1:].view(2, 6, 4, 64), False),
        "head_dim stride 2": (wide[..., ::2], False),
        "f32 contiguous": (x.float(), True),
    }


@pytest.mark.parametrize("name", list(_layout_views()))
def test_attention_kernel_layout(name):
    """``_kernel_layout`` passes a view the kernel can read (TMA boxes in
    bf16, 16-byte loads in f32) through untouched and copies any other
    into a contiguous tensor that it can, with the same values."""
    t, readable = _layout_views()[name]
    got = ops._kernel_layout(t)
    assert (got is t) == readable
    assert torch.equal(got, t) and got.stride(-1) == 1
    assert got.data_ptr() % 16 == 0
    assert all(st > 0 and st * got.element_size() % 16 == 0
               for st in got.stride()[:-1])
