"""The port's codecs against the JAX package's: wire bits and prices,
int lanes and scales, bf16 casts and EF residuals exactly (no generator,
so both round half to even); top-k on distinct magnitudes exactly;
stochastic rounding by its contract (floor or ceil, unbiased on
average), since the two packages draw different random numbers."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comms as jcomms  # noqa: E402
from repro_torch.comms import codecs  # noqa: E402

SPECS = ["none", "bf16", "int8", "int4", "int8:b64", "int4:b16",
         "topk:0.05", "topk:10", "int8+ef"]
SHAPES = [(40, 512), (512,), (512, 4), (4,), (3, 5, 7), (1000,)]


@pytest.mark.parametrize("spec", SPECS)
def test_bits_and_prices_exact(spec):
    ours, theirs = codecs.get_codec(spec), jcomms.get_codec(spec)
    assert ours.name == theirs.name
    assert ours.bits_per_param == theirs.bits_per_param
    for shape in SHAPES:
        assert ours.leaf_bits(shape) == theirs.leaf_bits(shape)
    tree_np = {"fc0": {"w": np.zeros((40, 512)), "b": np.zeros(512)},
               "fc1": {"w": np.zeros((512, 4)), "b": np.zeros(4)}}
    flat = {"fc0.w": torch.zeros(40, 512), "fc0.b": torch.zeros(512),
            "fc1.w": torch.zeros(512, 4), "fc1.b": torch.zeros(4)}
    assert ours.model_bits(flat) == theirs.model_bits(tree_np)
    for full_bits in (5.6e6 * 8, 811_524 * 32.0, 1000.0, 33.0):
        assert ours.price_bits(full_bits) == theirs.price_bits(full_bits)
        assert ours.price_bits(full_bits, 16.0) == \
            theirs.price_bits(full_bits, 16.0)


def _rows(seed, K=5, n=1000):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, n)).astype(np.float32)
    x[1] *= 100.0                    # a row with a larger scale
    x[2, : n // 2] *= 1e-3           # small and large channels in one row
    return x


@pytest.mark.parametrize("spec", ["int8", "int4", "int8:b64", "int4:b64",
                                  "int8:b7"])
def test_int_lanes_and_scales_exact(spec):
    x = _rows(1)
    ours, theirs = codecs.get_codec(spec), jcomms.get_codec(spec)
    enc = ours.encode_leaf(torch.from_numpy(x))
    jenc = jax.vmap(lambda r: theirs.encode_leaf(r, None))(jnp.asarray(x))
    assert enc["q"].dtype == torch.int8
    np.testing.assert_array_equal(enc["q"].numpy(), np.asarray(jenc["q"]))
    np.testing.assert_array_equal(enc["scale"].numpy(),
                                  np.asarray(jenc["scale"]))
    like = jax.ShapeDtypeStruct((x.shape[1],), jnp.float32)
    jdec = jax.vmap(lambda p: theirs.decode_leaf(p, like))(jenc)
    np.testing.assert_array_equal(ours.decode_leaf(enc, x.shape[1]).numpy(),
                                  np.asarray(jdec))


def test_round_half_to_even_without_generator():
    y = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 2.4999])
    np.testing.assert_array_equal(codecs._stochastic_round(y).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(y.numpy()))))


def test_bf16_cast_exact():
    x = _rows(2)
    enc = codecs.get_codec("bf16").encode_leaf(torch.from_numpy(x))
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(enc["v"].to(torch.float32).numpy(), want)
    np.testing.assert_array_equal(
        codecs.get_codec("bf16").decode_leaf(enc, x.shape[1]).numpy(), want)


def test_topk_decoded_exact_on_distinct_magnitudes():
    rng = np.random.default_rng(3)
    K, n = 4, 200
    mags = np.stack([rng.permutation(n) + 1.0 for _ in range(K)])
    x = (mags * rng.choice([-1.0, 1.0], (K, n))).astype(np.float32)
    ours, theirs = codecs.get_codec("topk:0.05"), jcomms.get_codec("topk:0.05")
    got = ours.decode_leaf(ours.encode_leaf(torch.from_numpy(x)), n).numpy()
    like = jax.ShapeDtypeStruct((n,), jnp.float32)
    want = jax.vmap(lambda r: theirs.decode_leaf(
        theirs.encode_leaf(r), like))(jnp.asarray(x))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("spec", ["int8", "int8:b64", "bf16"])
def test_error_feedback_step_exact(spec):
    x = _rows(4)
    r = (np.random.default_rng(5).standard_normal(x.shape) * 0.01
         ).astype(np.float32)
    ours = codecs.resolve_codec(spec)
    theirs = jcomms.resolve_codec(spec)
    assert isinstance(ours, codecs.ErrorFeedback) and ours.name == theirs.name
    _, xhat, res = ours.transmit(torch.from_numpy(x), torch.from_numpy(r))
    _, jxhat, jres = jax.vmap(lambda a, b: theirs.encode_leaf_stateful(a, b))(
        jnp.asarray(x), jnp.asarray(r))
    np.testing.assert_array_equal(xhat.numpy(), np.asarray(jxhat))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


@pytest.mark.parametrize("spec", ["int8", "int4:b64"])
def test_stochastic_rounding_contract(spec):
    codec = codecs.get_codec(spec)
    x = torch.from_numpy(_rows(6, K=3, n=4096))
    g = torch.Generator().manual_seed(0)
    enc = codec.encode_leaf(x, g)
    y = x / (enc["scale"][:, None] if codec.block is None else
             enc["scale"].repeat_interleave(codec.block, 1)[:, :x.shape[1]])
    q = enc["q"].to(torch.float32)
    assert bool(((q == torch.floor(y)) | (q == torch.ceil(y))).all())
    # unbiased: the mean rounding error is near 0 (4096·3 draws)
    err = (q - y)[y.abs() < codec.qmax - 1]
    assert abs(float(err.mean())) < 0.02
    # a seeded generator reproduces the lanes
    again = codec.encode_leaf(x, torch.Generator().manual_seed(0))
    assert torch.equal(again["q"], enc["q"])


def test_get_and_resolve_codec():
    assert codecs.get_codec(None) is None
    assert isinstance(codecs.resolve_codec("none"), codecs.IdentityCodec)
    assert codecs.resolve_codec("int8", error_feedback=False).name == "int8"
    assert codecs.resolve_codec("int8").name == "int8+ef"
    assert codecs.get_codec("int8:b64").block == 64
    with pytest.raises(ValueError):
        codecs.get_codec("int3")
    with pytest.raises(ValueError):
        codecs.ErrorFeedback(codecs.resolve_codec("bf16"))
    with pytest.raises(TypeError):
        codecs.get_codec(8)
    assert math.isclose(codecs.get_codec("int8").qmax, 127.0)
