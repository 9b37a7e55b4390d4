"""The port's two consensus kernels against the JAX package's Pallas
kernels: the port's plain versions (what its wrappers run on CPU tensors)
against ``repro.kernels.ops.*(impl="interpret")`` and the JAX oracles in
``repro.kernels.ref``, called once per agent on the gathered neighbour
block, at small shapes made with numpy from a seed. The CUDA kernels
themselves are held to the plain versions on the card, by the tests
marked ``gpu`` below (which also cover the RG-LRU scan and flash-attention
kernels, and their gradients through the plain versions; their CPU parity
tests are in ``test_torch_lm_kernels.py`` and ``test_torch_autograd.py``)
and by ``chip_smoke.py``."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

# f32: the JAX oracle sums the h terms with an einsum, the port's plain
# version in fixed h order, one rounded op at a time — a few ulps apart.
F32_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16: the output is rounded to bf16 on both sides (tests/test_kernels.py)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
K = 6


def _lanes(rng, H):
    """(K, H) neighbour indices and σ; with H > 1 the last lane of every
    other agent is a padding lane (own index, σ = 0)."""
    idx = np.zeros((K, H), np.int32)
    sig = np.zeros((K, H), np.float32)
    for k in range(K):
        others = rng.permutation([j for j in range(K) if j != k])[:H]
        idx[k] = others
        sig[k] = rng.uniform(0.05, 0.3, H)
        if H > 1 and k % 2:
            idx[k, -1], sig[k, -1] = k, 0.0
    return idx, sig


@pytest.fixture
def jax_kernels():
    """The JAX package's kernel wrappers and oracles, imported here so the
    card-only tests below run where JAX is not installed."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,N", [(1, 1000), (2, 1000), (4, 4099)])
def test_consensus_update_pop_matches_pallas(H, N, dtype, jax_kernels):
    jnp, jops, jref = jax_kernels
    rng = np.random.default_rng(H * 7 + N)
    x = rng.standard_normal((K, N)).astype(np.float32)
    idx, sig = _lanes(rng, H)
    if dtype == "bfloat16":
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        tol = BF16_TOL
    else:
        xj, xt, tol = jnp.asarray(x), torch.from_numpy(x), F32_TOL
    got = ops.consensus_update_pop(xt, torch.from_numpy(idx),
                                   torch.from_numpy(sig))
    assert got.dtype == xt.dtype and got.shape == (K, N)
    got = got.to(torch.float32).numpy()
    for k in range(K):
        nb = xj[idx[k]]
        want = jops.consensus_update(xj[k], nb, jnp.asarray(sig[k]),
                                     impl="interpret", block_n=256)
        oracle = jref.consensus_update_reference(xj[k], nb,
                                                 jnp.asarray(sig[k]))
        for w in (want, oracle):
            np.testing.assert_allclose(got[k], np.asarray(w, np.float32),
                                       **tol, err_msg=f"agent {k}")


@pytest.mark.parametrize("qblock", [None, 64])
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("H,N", [(1, 1000), (2, 1000), (4, 4099)])
def test_quant_consensus_pop_matches_pallas(H, N, qmax, qblock,
                                            jax_kernels):
    jnp, jops, jref = jax_kernels
    rng = np.random.default_rng(H * 11 + N + qmax)
    x = rng.standard_normal((K, N)).astype(np.float32)
    q = rng.integers(-qmax, qmax + 1, (K, N)).astype(np.int8)
    ns = 1 if qblock is None else -(-N // qblock)
    s = rng.uniform(0.001, 0.02, (K, ns)).astype(np.float32)
    if qblock is None:
        s = s[:, 0]
    idx, sig = _lanes(rng, H)
    got = ops.quant_consensus_pop(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
        torch.from_numpy(idx), torch.from_numpy(sig), qblock=qblock).numpy()
    kw = {} if qblock is None else {"qblock": qblock}
    for k in range(K):
        args = (jnp.asarray(x[k]), jnp.asarray(q[k]), jnp.asarray(s[k]),
                jnp.asarray(q[idx[k]]), jnp.asarray(s[idx[k]]),
                jnp.asarray(sig[k]))
        want = jops.quant_consensus_update(*args, impl="interpret",
                                           block_n=256, **kw)
        oracle = jref.quant_consensus_update_reference(*args, qblock=qblock)
        for w in (want, oracle):
            np.testing.assert_allclose(got[k], np.asarray(w), **F32_TOL,
                                       err_msg=f"agent {k}")


def test_zero_sigma_lanes_are_exact_noops():
    """Padding lanes (own index, σ = 0) change nothing, bit for bit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((K, 333)).astype(np.float32))
    idx, sig = _lanes(rng, 2)
    idx[:, 1], sig[:, 1] = np.arange(K), 0.0
    one = ops.consensus_update_pop(x, torch.from_numpy(idx[:, :1]),
                                   torch.from_numpy(sig[:, :1]))
    two = ops.consensus_update_pop(x, torch.from_numpy(idx),
                                   torch.from_numpy(sig))
    assert torch.equal(one, two)
    q = torch.from_numpy(rng.integers(-127, 128, (K, 333)).astype(np.int8))
    s = torch.full((K,), 0.01)
    one = ops.quant_consensus_pop(x, q, s, torch.from_numpy(idx[:, :1]),
                                  torch.from_numpy(sig[:, :1]))
    two = ops.quant_consensus_pop(x, q, s, torch.from_numpy(idx),
                                  torch.from_numpy(sig))
    assert torch.equal(one, two)
    # all-zero σ returns x itself
    zero = ops.consensus_update_pop(x, torch.from_numpy(idx),
                                    torch.zeros(K, 2))
    assert torch.equal(zero, x)


def test_wrapper_guards_and_no_fallback():
    x = torch.zeros(4, 8)
    idx = torch.zeros(4, 1, dtype=torch.int32)
    sig = torch.ones(4, 1)
    with pytest.raises(TypeError):
        ops.consensus_update_pop(x.to(torch.int32), idx, sig)
    with pytest.raises(ValueError):
        ops.consensus_update_pop(x, idx, torch.ones(4, 2))
    with pytest.raises(TypeError):
        ops.quant_consensus_pop(x, torch.zeros(4, 8, dtype=torch.int16),
                                torch.ones(4), idx, sig)
    with pytest.raises(ValueError):      # block scales need ceil(8/4) each
        ops.quant_consensus_pop(x, torch.zeros(4, 8, dtype=torch.int8),
                                torch.ones(4, 3), idx, sig, qblock=4)
    # neighbour indices outside [0, K) would read past the stack
    for bad in (4, -1):
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            ops.consensus_update_pop(x, torch.full_like(idx, bad), sig)
        with pytest.raises(ValueError, match=r"\[0, 4\)"):
            ops.quant_consensus_pop(x, torch.zeros(4, 8, dtype=torch.int8),
                                    torch.ones(4), torch.full_like(idx, bad),
                                    sig)
    # a tensor on a device with no kernel raises instead of falling back
    # to the plain version (``meta`` is the dry run's: shapes, no launch)
    other = [t.as_subclass(OtherDevice) for t in (x, idx, sig)]
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops.consensus_update_pop(*other)
    before = ops.consensus_update_pop.launches
    out = ops.consensus_update_pop(x.to("meta"), idx.to("meta"),
                                   sig.to("meta"))
    assert out.device.type == "meta" and out.shape == x.shape
    assert ops.consensus_update_pop.launches == before


class OtherDevice(torch.Tensor):
    """A CPU tensor that reports a device the wrappers have no kernel for
    (``xpu``)."""

    @property
    def device(self):
        return torch.device("xpu")


def _source_case(rng, N, qblock=None, B=3):
    """A population of K rows and one block of its B rows: the block's
    own rows, the lane tables of its agents (indexing the population) and
    the population's int wire."""
    x = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    idx, sig = (torch.from_numpy(a) for a in _lanes(rng, 3))
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    ns = (K,) if qblock is None else (K, -(-N // qblock))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, ns).astype(np.float32))
    return x, idx, sig, q, s, slice(K - B, K)


@pytest.mark.parametrize("qblock", [None, 64])
def test_source_form_equals_population_rows(qblock):
    """A block of owned rows mixed from the whole population as the
    source gives exactly those rows of the population form: the sharded
    plan's per-block launch is the sparse plan's arithmetic."""
    rng = np.random.default_rng(11)
    x, idx, sig, q, s, blk = _source_case(rng, 1000, qblock)
    for xd in (x, x.to(torch.bfloat16)):
        full = ops.consensus_update_pop(xd, idx, sig)
        part = ops.consensus_update_pop(xd[blk], idx[blk], sig[blk], src=xd)
        assert torch.equal(part, full[blk])
    full = ops.quant_consensus_pop(x, q, s, idx, sig, qblock=qblock)
    part = ops.quant_consensus_pop(x[blk], q[blk], s[blk], idx[blk],
                                   sig[blk], qblock=qblock, q_src=q, s_src=s)
    assert torch.equal(part, full[blk])


def test_source_form_guards():
    x = torch.zeros(2, 8)
    src = torch.zeros(5, 8)
    sig = torch.ones(2, 1)
    # indices are bounded by the SOURCE's rows, not the owned rows'
    ok = ops.consensus_update_pop(x, torch.full((2, 1), 4), sig, src=src)
    assert ok.shape == (2, 8)
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        ops.consensus_update_pop(x, torch.full((2, 1), 5), sig, src=src)
    with pytest.raises(ValueError, match="src"):
        ops.consensus_update_pop(x, torch.zeros(2, 1, dtype=torch.int32),
                                 sig, src=torch.zeros(5, 9))
    with pytest.raises(ValueError, match="src"):
        ops.consensus_update_pop(x, torch.zeros(2, 1, dtype=torch.int32),
                                 sig, src=src.to(torch.bfloat16))
    q, qs = torch.zeros(2, 8, dtype=torch.int8), torch.zeros(5, 8,
                                                            dtype=torch.int8)
    with pytest.raises(ValueError, match="together"):
        ops.quant_consensus_pop(x, q, torch.ones(2), torch.zeros(
            2, 1, dtype=torch.int32), sig, q_src=qs)
    with pytest.raises(ValueError, match="s_src"):
        ops.quant_consensus_pop(x, q, torch.ones(2), torch.zeros(
            2, 1, dtype=torch.int32), sig, q_src=qs, s_src=torch.ones(4))
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        ops.quant_consensus_pop(x, q, torch.ones(2), torch.full((2, 1), 5),
                                sig, q_src=qs, s_src=torch.ones(5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,N", [(1, 1000), (4, 4099), (2, 262144)])
def test_cuda_consensus_kernel_matches_plain(cuda, H, N, dtype):
    rng = np.random.default_rng(N)
    x = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    x = x.to(cuda, dtype)
    idx, sig = (torch.from_numpy(a).to(cuda) for a in _lanes(rng, H))
    got = ops.consensus_update_pop(x, idx, sig)
    torch.cuda.synchronize()
    want = ref.consensus_update_pop_reference(x, idx, sig)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("call", [
    "ops.consensus_update_pop(x, idx, sig)",
    "ops.quant_consensus_pop(x, x.to(torch.int8), x[:, 0] + 1, idx, sig)"])
def test_cuda_kernels_trap_on_out_of_range_index(cuda, call):
    """An index outside [0, K) aborts the launch instead of reading past
    the stack. Run in a child process: the trap leaves that process's CUDA
    context unusable."""
    code = textwrap.dedent(f"""
        import torch
        from repro_torch.kernels import ops
        x = torch.zeros(4, 64, device="cuda")
        idx = torch.full((4, 1), 4, dtype=torch.int32, device="cuda")
        sig = torch.ones(4, 1, device="cuda")
        {call}
        torch.cuda.synchronize()
        print("NO TRAP")
    """)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode != 0 and "NO TRAP" not in r.stdout, r.stdout + r.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("qblock", [None, 64])
@pytest.mark.parametrize("H,N", [(1, 1000), (4, 4099), (2, 262144)])
def test_cuda_quant_kernel_matches_plain(cuda, H, N, qblock):
    rng = np.random.default_rng(N + 1)
    x = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    ns = (K,) if qblock is None else (K, -(-N // qblock))
    s = torch.from_numpy(rng.uniform(0.001, 0.02, ns).astype(np.float32))
    idx, sig = (torch.from_numpy(a) for a in _lanes(rng, H))
    args = [t.to(cuda) for t in (x, q, s, idx, sig)]
    got = ops.quant_consensus_pop(*args, qblock=qblock)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.quant_consensus_pop_reference(*args, qblock))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,W,h0", [(2, 100, 48, True), (1, 37, 4096, False),
                                      (4, 1024, 520, True),
                                      # T not a multiple of the 16-step tile
                                      (1, 1000, 520, True),
                                      # the serving width at its batch
                                      (4, 200, 4096, True),
                                      # W not 16-byte aligned in bf16 / in
                                      # both: tiles filled by plain loads
                                      (2, 65, 100, False), (2, 37, 37, True)])
def test_cuda_rglru_scan_matches_plain(cuda, B, T, W, h0, dtype):
    """Same steps in the same order, expf and no FMA contraction: equal
    bit for bit, ragged T and W included."""
    rng = np.random.default_rng(T + W)
    x = rng.standard_normal((B, T, W)).astype(np.float32)
    log_a = torch.from_numpy(-np.logaddexp(x, 0.0)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((B, T, W)).astype(np.float32))
    b = b.to(cuda, dtype)
    hz = torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
    hz = hz.to(cuda) if h0 else None
    before = ops.rglru_scan.launches
    h, h_last = ops.rglru_scan(log_a, b, hz)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    wh, whl = ref.rglru_scan_reference(log_a, b, hz)
    assert torch.equal(h, wh) and torch.equal(h_last, whl)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,causal,window,softcap", [
    (2, 128, 4, 2, 64, True, 0, 0.0),
    (1, 1000, 8, 2, 120, True, 0, 0.0),      # ragged S, hd not a power of 2
    (1, 128, 4, 2, 128, False, 0, 0.0),
    (2, 300, 16, 1, 256, True, 128, 30.0),   # recurrentgemma's shape, cut
    (1, 77, 2, 2, 16, True, 32, 0.0),
    # tile edges: S, T not multiples of 64 or 128, windows not multiples of
    # 64, H/K of 1, 2 and 16, hd of 16, 120, 256 and one not a multiple of 8
    (1, 200, 16, 16, 256, True, 100, 30.0),
    (1, 1000, 16, 1, 256, True, 300, 30.0),
    (2, 200, 4, 2, 16, True, 100, 0.0),
    (1, 1000, 2, 1, 120, False, 300, 0.0),
    (1, 200, 2, 2, 20, True, 0, 0.0),
    # h2o-danube-3-4b's heads (GQA 32/8, hd 120, window = S) and
    # qwen2-moe-a2.7b's (MHA 16 x 128), S cut from 4096
    (1, 520, 32, 8, 120, True, 520, 0.0),
    (1, 520, 16, 16, 128, True, 0, 0.0),
])
def test_cuda_flash_attention_matches_plain(cuda, B, S, H, K, hd, causal,
                                            window, softcap, dtype):
    """Online softmax in f32 against the plain one-pass softmax: the JAX
    package's own tolerances for its Pallas kernel (tests/test_kernels.py)."""
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype)
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = ref.attention_reference(q, k, v, **kw)
    tol = 2e-3 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["transposed", "sliced"])
def test_cuda_flash_attention_strided_views(cuda, view, dtype):
    """q, k, v as views (heads-major storage, or a slice of wider rows) and
    T != S give what their contiguous copies give, bit for bit."""
    rng = np.random.default_rng(11)
    B, S, T, H, K, hd = 2, 200, 330, 4, 2, 64

    def make(n, L):
        x = torch.from_numpy(rng.standard_normal(
            (B, n, L, 2 * hd) if view == "sliced" else (B, n, L, hd))
            .astype(np.float32)).to(cuda, dtype)
        return x[..., :hd] if view == "sliced" else \
            x.transpose(1, 2).contiguous().transpose(1, 2)

    q, k, v = make(S, H), make(T, K), make(T, K)
    assert not q.is_contiguous()
    for kw in (dict(causal=True, window=100, softcap=30.0),
               dict(causal=False, window=0, softcap=0.0)):
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        plain = ref.attention_reference(q, k, v, **kw)
        tol = 2e-3 if dtype == torch.float32 else 6e-2
        torch.testing.assert_close(got.float(), plain.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [128, 100])
@pytest.mark.parametrize("qscale", [1.0, 20.0])
def test_cuda_flash_attention_bf16_within_rounding(cuda, qscale, window):
    """bf16 at recurrentgemma's heads, cut in length, against the plain
    version to within its roundings: the plain version rounds each
    probability to bf16 (relative error <= 2^-8; the kernel carries them
    as two bf16 terms, within 2^-16) and both round the output (ulp <=
    2^-7 |x|), so |kernel - plain| <= 2^-7 |plain| + 2^-8 P|v|, gated at
    that plus 1e-5. At q x 20 the scores reach the softcap, and the same
    gate refuses the uncapped attention. A window of 100 puts its lower
    edge inside kv tiles."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda) for s in ((2, 300, 16, 256), (2, 300, 1, 256),
                                   (2, 300, 1, 256)))
    q = (q * qscale).to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=30.0)
    got = ops.flash_attention(q, k, v, **kw).float()
    want = ref.attention_reference(q, k, v, **kw).float()
    pv = ref.attention_reference(q.float(), k.float(), v.float().abs(), **kw)
    gate = 2.0 ** -7 * want.abs() + 2.0 ** -8 * pv + 1e-5
    assert float(((got - want).abs() / gate).max()) <= 1.0
    if qscale > 1:
        uncapped = ref.attention_reference(q, k, v, causal=True,
                                           window=window).float()
        assert float(((uncapped - want).abs() / gate).max()) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [64, 1500])
def test_cuda_flash_attention_bf16_unmasked_at_whisper_shapes(cuda, S):
    """bf16, no mask, at whisper-large-v3's heads (H = K = 20, hd 64)
    over its 1500 encoder frames (a 28-key tail in the last 64-key tile):
    the encoder's self-attention (S = 1500) and a 64-token decoder prompt's
    cross-attention (S = 64), within the rounding gate above."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((2, S, 20, 64), (2, 1500, 20, 64), (2, 1500, 20, 64)))
    kw = dict(causal=False, window=0, softcap=0.0)
    got = ops.flash_attention(q, k, v, **kw).float()
    want = ref.attention_reference(q, k, v, **kw).float()
    pv = ref.attention_reference(q.float(), k.float(), v.float().abs(), **kw)
    gate = 2.0 ** -7 * want.abs() + 2.0 ** -8 * pv + 1e-5
    assert bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / gate).max()) <= 1.0


def _dynamic_sigma(rng, sig, table):
    """σ tables of rounds where links fade and agents sleep: lanes at
    σ = 0 (faded, sleeping, padding), fractional λ^age weights, rows that
    are all zero, and a round in which every lane is dead."""
    sig = sig.copy()
    if table == "zeros":
        sig[rng.uniform(size=sig.shape) < 0.4] = 0.0
    elif table == "decay":
        sig *= np.float32(0.9) ** rng.integers(0, 4, sig.shape)
    elif table == "dead_rows":
        sig[::2] = 0.0
    else:                                            # a dead round
        sig[:] = 0.0
    return sig.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("table", ["zeros", "decay", "dead_rows", "dead"])
@pytest.mark.parametrize("H,N", [(2, 4099), (4, 262144)])
def test_cuda_kernels_on_dynamic_sigma_tables(cuda, H, N, table):
    """Both consensus kernels on the σ tables of fading and async rounds
    equal their plain versions bit for bit (f32 and bf16 x for B2,
    per-tensor and block scales for B1); a dead round leaves x as it was."""
    rng = np.random.default_rng(N + H)
    idx, sig = _lanes(rng, H)
    sig = _dynamic_sigma(rng, sig, table)
    x = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    idx_t, sig_t = torch.from_numpy(idx).to(cuda), torch.from_numpy(sig).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(cuda, dtype)
        got = ops.consensus_update_pop(xd, idx_t, sig_t)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.consensus_update_pop_reference(
            xd, idx_t, sig_t))
        if table == "dead":
            assert torch.equal(got, xd)
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    for qblock in (None, 64):
        ns = (K,) if qblock is None else (K, -(-N // qblock))
        s = torch.from_numpy(rng.uniform(0.001, 0.02, ns).astype(np.float32))
        args = [t.to(cuda) for t in (x, q, s)] + [idx_t, sig_t]
        got = ops.quant_consensus_pop(*args, qblock=qblock)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.quant_consensus_pop_reference(*args,
                                                                  qblock))
        if table == "dead":
            assert torch.equal(got, args[0])


@pytest.mark.gpu
def test_cuda_masks_equal_cpu_masks(cuda):
    """Survival (dense and per-edge) and availability masks drawn on the
    card equal the same draws on the CPU, for a whole chunk of rounds."""
    from repro_torch.core import topology
    topo = topology.small_world(256, k=4, seed=1)
    rounds = torch.arange(3, 11)
    for p in (0.0, 0.3, 1.0):
        masks = [topology.survival_mask(topo.adjacency, p,
                                        topology.survival_key(7, dev),
                                        rounds.to(dev)).cpu()
                 for dev in ("cpu", cuda)]
        assert torch.equal(*masks)
        rows = np.arange(256)[:, None]
        cols = np.random.default_rng(1).integers(0, 256, (256, 4))
        lanes = [topology.survival_mask(256, p, topology.survival_key(7, dev),
                                        rounds.to(dev), symmetric=True,
                                        receivers=rows, senders=cols).cpu()
                 for dev in ("cpu", cuda)]
        assert torch.equal(*lanes)
    rates = np.random.default_rng(2).uniform(size=256)
    for p_inactive in (0.25, rates):
        acts = [topology.availability_mask(256, p_inactive,
                                           topology.availability_key(5, dev),
                                           rounds.to(dev)).cpu()
                for dev in ("cpu", cuda)]
        assert torch.equal(*acts)


@pytest.mark.gpu
def test_cuda_telemetry_rows_equal_cpu_rows(cuda):
    """Three async rounds with fading links on the sparse plan (K = 256,
    int8 wire through B1), drawn and recorded on the card and on the CPU:
    every row's link counts, per-sender counts (``index_add_`` over the
    lane table), activity, ages and float64 joules are equal; the
    disagreement (a reduction in another order) within rel 1e-5."""
    from repro_torch.core import topology
    from repro_torch.core.engine import ConsensusEngine
    from repro_torch.telemetry import Telemetry
    topo = topology.small_world(256, k=4, seed=1)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((256, 4099)).astype(np.float32),
              "b": rng.standard_normal((256, 7)).astype(np.float32)}
    events = []
    for dev in ("cpu", cuda):
        eng = ConsensusEngine(
            topo, codec="int8", plan="sparse",
            graph=topology.GraphProcess.dropout(0.3, seed=1),
            agents=topology.AgentProcess.bernoulli(0.7), tau=2,
            staleness_decay=0.9)
        tel = Telemetry()
        eng.scan_rounds({k: torch.from_numpy(v).to(dev)
                         for k, v in params.items()}, rounds=3, telemetry=tel)
        events.append(tel.events(driver="consensus"))
    assert len(events[0]) == len(events[1]) == 3
    for e, g in zip(*events):
        for f in ("n_sl", "n_ul", "n_dl", "edges", "n_active", "max_age",
                  "agent_sl", "agent_ul", "agent_dl", "joules",
                  "agent_joules"):
            assert e[f] == g[f], f
        assert g["disagreement"] == pytest.approx(e["disagreement"], rel=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1000, 4099, 262144])
def test_cuda_kernels_source_form_match_plain(cuda, N):
    """Both consensus kernels in their source form (a block of owned rows
    mixed from the population's rows or wire, and one agent from M
    received rows) equal their plain versions bit for bit, and the block
    equals those rows of the population form."""
    rng = np.random.default_rng(N + 5)
    for qblock in (None, 64):
        x, idx, sig, q, s, blk = (t.to(cuda) if isinstance(t, torch.Tensor)
                                  else t for t in _source_case(rng, N, qblock))
        for xd in (x, x.to(torch.bfloat16)):
            got = ops.consensus_update_pop(xd[blk], idx[blk], sig[blk],
                                           src=xd)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.consensus_update_pop_reference(
                xd[blk], idx[blk], sig[blk], xd))
            assert torch.equal(got, ops.consensus_update_pop(xd, idx,
                                                             sig)[blk])
        got = ops.quant_consensus_pop(x[blk], q[blk], s[blk], idx[blk],
                                      sig[blk], qblock=qblock, q_src=q,
                                      s_src=s)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.quant_consensus_pop_reference(
            x[blk], q[blk], s[blk], idx[blk], sig[blk], qblock, q, s))
        assert torch.equal(got, ops.quant_consensus_pop(
            x, q, s, idx, sig, qblock=qblock)[blk])
        # one agent mixing M = K - 1 received rows (the distributed plan)
        lanes = torch.arange(K - 1, device=cuda)[None, :]
        w = sig[:1].repeat(1, K)[:, :K - 1].contiguous()
        got = ops.quant_consensus_pop(x[:1], q[:1], s[:1], lanes, w,
                                      qblock=qblock, q_src=q[1:],
                                      s_src=s[1:])
        torch.cuda.synchronize()
        assert torch.equal(got, ref.quant_consensus_pop_reference(
            x[:1], q[:1], s[:1], lanes, w, qblock, q[1:], s[1:]))


def _grad_gate(got, want, dtype, routes=1):
    """f32: within 1e-4 of each gradient's largest entry; bf16: within one
    bf16 rounding (2^-7) of it, times ``routes``: 2 where ``want`` is
    autograd through the plain forward, which reaches the gradient by
    another route than the backward kernel's (each within one rounding of
    the exact gradient)."""
    rel = routes * (1e-4 if dtype == torch.float32 else 2.0 ** -7)
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= rel * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,hd,window", [
    (2, 256, 32, 8, 128, 0),          # granite-8b's heads, S cut
    (1, 300, 16, 1, 256, 128),        # recurrentgemma's, ragged S
])
def test_cuda_flash_attention_gradient_matches_plain(cuda, B, S, H, K, hd,
                                                     window, dtype):
    """B4 on the card with a gradient: the forward launches the kernel once
    and agrees with the plain version; the backward launches B4′ once, and
    dq, dk, dv agree with its plain version and with autograd through the
    plain forward on the card."""
    rng = np.random.default_rng(S + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda, dtype).requires_grad_()
               for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    w = torch.from_numpy(rng.standard_normal((B, S, H, hd))
                         .astype(np.float32)).to(cuda)
    kw = dict(causal=True, window=window)
    before = (ops.flash_attention.launches,
              ops.flash_attention_backward.launches)
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert (ops.flash_attention.launches,
            ops.flash_attention_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
    plain = ref.attention_reference(q, k, v, **kw)
    want = torch.autograd.grad((plain.float() * w).sum(), (q, k, v))
    bwd = ref.attention_backward_reference(
        q.detach(), k.detach(), v.detach(), w.to(dtype), **kw)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol, atol=tol)
    _grad_gate(got, want, dtype, routes=2)
    _grad_gate(got, bwd, dtype)


@pytest.mark.gpu
def test_cuda_flash_attention_vmap_grad_launches_once(cuda):
    """``torch.func.vmap(grad)`` over 3 q batches: one kernel launch, and
    the gradients of a loop of ``grad`` through the plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qs = torch.randn(3, 2, 128, 8, 64, generator=g, device=cuda)
    k, v = (torch.randn(2, 128, 2, 64, generator=g, device=cuda)
            for _ in range(2))

    def loss(attn):
        return lambda q, k, v: attn(q, k, v, causal=True,
                                    window=0).square().sum()

    before = (ops.flash_attention.launches,
              ops.flash_attention_backward.launches)
    got = torch.func.vmap(torch.func.grad(loss(ops.flash_attention),
                                          argnums=(0, 1, 2)),
                          in_dims=(0, None, None))(qs, k, v)
    assert (ops.flash_attention.launches,
            ops.flash_attention_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = [torch.func.grad(loss(ref.attention_reference),
                            argnums=(0, 1, 2))(qs[i], k, v)
            for i in range(3)]
    for j in range(3):
        _grad_gate([got[j]], [torch.stack([w_[j] for w_ in want])],
                   torch.float32)


@pytest.mark.gpu
def test_cuda_rglru_scan_gradient_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    log_a = (-torch.rand(2, 256, 512, generator=g, device=cuda)
             * 0.5).requires_grad_()
    b = torch.randn(2, 256, 512, generator=g, device=cuda).requires_grad_()
    h0 = torch.randn(2, 512, generator=g, device=cuda).requires_grad_()
    before = (ops.rglru_scan.launches, ops.rglru_scan_backward.launches)
    h, last = ops.rglru_scan(log_a, b, h0)
    got = torch.autograd.grad(h.square().sum() + last.sum(), (log_a, b, h0))
    assert (ops.rglru_scan.launches,
            ops.rglru_scan_backward.launches) == (before[0] + 1,
                                                  before[1] + 1)
    wh, wl = ref.rglru_scan_reference(log_a, b, h0)
    want = torch.autograd.grad(wh.square().sum() + wl.sum(), (log_a, b, h0))
    torch.cuda.synchronize()
    assert torch.equal(h, wh) and torch.equal(last, wl)
    # B3′ takes autograd's rounded steps in the same order
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _b3p_inputs(cuda, B, T, W, dtype, with_h0, with_last):
    g = torch.Generator(device=cuda).manual_seed(T)
    log_a = (-torch.rand(B, T, W, generator=g, device=cuda) * 0.5).to(dtype)
    b, gh = (torch.randn(B, T, W, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    h0, gl = (torch.randn(B, W, generator=g, device=cuda) if on else None
              for on in (with_h0, with_last))
    h, _ = ops.rglru_scan(log_a, b, h0)
    return log_a, b, h0, h, gh, gl


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0,with_last", [(False, False), (True, True)])
@pytest.mark.parametrize("B,T,W", [
    (2, 37, 40), (2, 512, 4096),
    # B3′'s chunks (64 steps) and cluster (8): T = 1, T = L with a ragged
    # W, S·L ± 1, two laps, a ragged third; W odd (no TMA), B = 3
    (3, 1, 100), (3, 64, 4100), (3, 511, 1000), (2, 513, 72),
    (2, 1024, 4096), (3, 1101, 515)])
def test_cuda_rglru_scan_backward_equals_plain(cuda, B, T, W, with_h0,
                                               with_last, dtype):
    """B3′ ``==`` its plain version: f32 reading the saved output as the
    carry, bf16 and f32 without it recomputing the carry; one launch a
    call."""
    log_a, b, h0, h, gh, gl = _b3p_inputs(cuda, B, T, W, dtype, with_h0,
                                          with_last)
    want = ref.rglru_scan_backward_reference(log_a, b, h0, h, gh, gl)
    for saved in (h, None):
        before = ops.rglru_scan_backward.launches
        got = ops.rglru_scan_backward(log_a, b, h0, saved, gh, gl)
        assert ops.rglru_scan_backward.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (got[2] is None) == (h0 is None)
        assert h0 is None or torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,W", [(2, 512, 4096), (3, 1101, 515)])
def test_cuda_rglru_scan_backward_deterministic_and_captured(cuda, B, T, W,
                                                             dtype):
    """Two launches of B3′ give equal bits (no atomics), and a launch
    captured in a CUDA graph and replayed ``==`` the eager one (the kernel
    allocates nothing; the entry-carry scratch comes from the graph's
    pool)."""
    log_a, b, h0, h, gh, gl = _b3p_inputs(cuda, B, T, W, dtype, True, True)
    for saved in (h, None):
        def call():
            return ops.rglru_scan_backward(log_a, b, h0, saved, gh, gl)
        first, second = call(), call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        before = ops.rglru_scan_backward.launches
        graph.replay()
        assert ops.rglru_scan_backward.launches == before
        torch.cuda.synchronize()
        for x, y, z in zip(first, second, captured):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,K,T,hd,causal,window,softcap,qscale", [
    (2, 256, 32, 8, 256, 128, True, 0, 0.0, 1.0),     # granite-8b, S cut
    (1, 300, 16, 1, 300, 256, True, 128, 30.0, 1.0),  # recurrentgemma local
    (2, 64, 4, 4, 150, 64, False, 0, 0.0, 1.0),       # cross-attention S != T
    (2, 100, 4, 2, 100, 120, True, 0, 0.0, 1.0),      # danube's head_dim
    (1, 70, 6, 3, 70, 80, False, 9, 0.0, 1.0),        # window, no causal
    # head_dim 256, MQA: the dk/dv grid's head split (16 kv tiles)
    (2, 512, 16, 1, 512, 256, True, 2048, 30.0, 1.0),
    (1, 1500, 4, 4, 1500, 64, False, 0, 0.0, 1.0),    # whisper's ragged T
    (2, 100, 4, 2, 100, 36, True, 0, 0.0, 1.0),       # head_dim padded to 40
    (2, 256, 8, 2, 256, 128, True, 0, 0.0, 20.0),     # a sharp softmax
])
def test_cuda_flash_attention_backward_matches_plain(
        cuda, B, S, H, K, T, hd, causal, window, softcap, qscale, dtype):
    """B4′ against its plain version: f32 within 1e-4, bf16 within 2^-7
    of each gradient's largest entry; one launch a call; two launches give
    the same bits (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q, go = (torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    q = (q.float() * qscale).to(dtype)
    k, v = (torch.randn(B, T, K, hd, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.flash_attention_backward.launches
    got = ops.flash_attention_backward(q, k, v, go, **kw)
    again = ops.flash_attention_backward(q, k, v, go, **kw)
    assert ops.flash_attention_backward.launches == before + 2
    want = ref.attention_backward_reference(q, k, v, go, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(a.dtype == dtype for a in got)
    _grad_gate(got, want, dtype)
