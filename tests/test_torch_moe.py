"""The port's MoE MLP against the JAX package's ``moe_block`` on the same
numpy inputs, with the JAX params carried across by ``convert``: reduced
mixtral-8x7b (4 experts, top-2) and reduced qwen2-moe-a2.7b (4 experts,
top-2, one shared expert), at the default capacity factor (assignments
drop), at ``capacity=1`` and at factor 8.0 (nothing drops).

The routing is compared exactly: each token's top-k expert SET (a token's
k choices may come back in another order on ties) and the kept (token,
expert) assignments, read off the reference's own top-k and
position-in-expert during its eager run. Outputs and the aux loss are
compared within a stated tolerance."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# f32: the same ops, matmul and k-sums in another order. The JAX init takes
# the first axis of a 3-d stack as its fan-in (E = 4), so the expert
# weights have std 0.5 and outputs reach ~10^3: the absolute part of the
# tolerance scales with the largest output
OUT_RTOL, OUT_ATOL_REL = 1e-5, 1e-5
AUX_TOL = dict(rtol=1e-6, atol=1e-7)
ARCHS = ["mixtral-8x7b", "qwen2-moe-a2.7b"]
B, S = 2, 40


def _cfgs(arch, factor=None):
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    if factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
    return jcfg, cfg


def _pair(arch, factor=None, seed=0):
    jcfg, cfg = _cfgs(arch, factor)
    jp = jmoe.init_moe_mlp(jax.random.PRNGKey(seed), jcfg)
    tp = moe.MoeMlp(cfg, device="cpu")
    tp.load_state_dict(params_from_numpy(jp, device="cpu"))
    return jcfg, cfg, jp, tp


def _x(cfg, seed=1):
    """Tokens that share one direction besides their own noise, so the
    router sends more of them to some experts than to others and the
    default capacity overflows."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(cfg.d_model)
    return (rng.standard_normal((B, S, cfg.d_model)) + common).astype(
        np.float32)


def _reference_with_routing(monkeypatch, jp, jcfg, x, capacity):
    """The JAX ``moe_block`` run eagerly, with its top-k indices and its
    position-in-expert (before dropped ones are zeroed) recorded."""
    seen = {"top_k": [], "pos": []}
    top_k, take = jax.lax.top_k, jnp.take_along_axis

    def spy_top_k(*a, **kw):
        out = top_k(*a, **kw)
        seen["top_k"].append(np.asarray(out[1]))
        return out

    def spy_take(*a, **kw):
        out = take(*a, **kw)
        seen["pos"].append(np.asarray(out)[:, 0])
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jnp, "take_along_axis", spy_take)
    y, aux = jmoe.moe_block(jp, jcfg, jnp.asarray(x), capacity=capacity)
    monkeypatch.undo()
    assert len(seen["top_k"]) == 1 and len(seen["pos"]) == 1
    return np.asarray(y), float(aux), seen["top_k"][0], seen["pos"][0]


def _kept_pairs(experts, keep, E):
    """(N, E) bool: token i's assignment to expert e is kept."""
    experts = np.asarray(experts).reshape(-1)
    keep = np.asarray(keep).reshape(-1)
    k = experts.size // (B * S)
    out = np.zeros((B * S, E), bool)
    tok = np.repeat(np.arange(B * S), k)
    out[tok[keep], experts[keep]] = True
    return out


CASES = [("default", None, None), ("capacity=1", None, 1),
         ("factor 8", 8.0, None)]


@pytest.mark.parametrize("case,factor,capacity", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(monkeypatch, arch, case, factor, capacity):
    jcfg, cfg, jp, tp = _pair(arch, factor)
    x = _x(cfg)
    jy, jaux, jidx, jpos = _reference_with_routing(monkeypatch, jp, jcfg, x,
                                                   capacity)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    xf = torch.from_numpy(x).reshape(B * S, -1)
    with torch.no_grad():
        r = moe.route(tp, cfg, xf, capacity=capacity)
        y, aux = moe.moe_block(tp, cfg, torch.from_numpy(x),
                               capacity=capacity)
    cap = capacity or max(int(np.ceil(k * B * S / E
                                      * cfg.moe.capacity_factor)), 1)
    assert r.cap == cap
    # routing: the same expert set per token and the same kept assignments
    assert np.array_equal(np.sort(r.experts.numpy().reshape(-1, k), 1),
                          np.sort(jidx, 1))
    jkeep = _kept_pairs(jidx, jpos < cap, E)
    kept = _kept_pairs(r.experts.numpy(), r.keep.numpy(), E)
    assert np.array_equal(kept, jkeep)
    if case == "factor 8":
        assert kept.sum() == B * S * k            # nothing drops
    else:
        assert kept.sum() < B * S * k             # drops happen
    np.testing.assert_allclose(y.numpy(), jy, rtol=OUT_RTOL,
                               atol=OUT_ATOL_REL * np.abs(jy).max())
    np.testing.assert_allclose(float(aux), jaux, **AUX_TOL)


def test_position_in_expert_is_the_token_major_prior_count():
    """pos of assignment (i, j) = how many earlier assignments in the
    flattened token-major order went to its expert; kept iff pos < cap
    (a loop over the assignments, the rule written out)."""
    _, cfg, _, tp = _pair("qwen2-moe-a2.7b")
    xf = torch.from_numpy(_x(cfg, seed=3)).reshape(B * S, -1)
    r = moe.route(tp, cfg, xf, capacity=7)
    seen = {}
    for a, e in enumerate(r.experts.tolist()):
        prior = seen.get(e, 0)
        seen[e] = prior + 1
        assert bool(r.keep[a]) == (prior < 7), a
        assert int(r.pos[a]) == (prior if prior < 7 else 0), a


def test_dropped_assignment_contributes_zero():
    """With capacity 1 a token whose every assignment dropped gets only
    the shared expert's output (qwen2-moe) or zero (mixtral)."""
    for arch in ARCHS:
        _, cfg, _, tp = _pair(arch)
        x = torch.from_numpy(_x(cfg, seed=4))
        xf = x.reshape(B * S, -1)
        with torch.no_grad():
            r = moe.route(tp, cfg, xf, capacity=1)
            y, _ = moe.moe_block(tp, cfg, x, capacity=1)
        k = cfg.moe.top_k
        dead = ~r.keep.reshape(-1, k).any(1)
        assert bool(dead.any())
        want = torch.zeros_like(xf[dead])
        if hasattr(tp, "shared"):
            with torch.no_grad():
                sg = torch.sigmoid(xf @ tp.shared_gate)
                want = (L.mlp_block(tp.shared, cfg, xf) * sg)[dead]
        torch.testing.assert_close(y.reshape(B * S, -1)[dead], want,
                                   rtol=0, atol=0)
