"""The port's optimizers and learning-rate schedules (``repro_torch.optim``)
against the JAX package's ``repro.optim``: the same numpy-made params and
gradients through 5 steps of each optimizer (with the gradient clipped to
a global norm, then applied), params, the global norm and the state's
step held at rtol 1e-6 (f32: the same ops, one rounded op at a time), and
each schedule's lr at every step."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
STEPS = 5
SHAPES = {"w": (6, 5), "blocks.attn.wq": (2, 4, 3), "b": (7,)}

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "adam": lambda m: m.adam(1e-2),
    "adam_betas": lambda m: m.adam(3e-3, b1=0.8, b2=0.99, eps=1e-6),
    "adamw": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "adam_cosine": lambda m: m.adam(m.cosine_decay(1e-2, 4)),
    "adam_warmup_cosine": lambda m: m.adam(m.warmup_cosine(1e-2, 2, 5)),
    "sgd_constant": lambda m: m.sgd(m.constant(0.05)),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_five_steps_match_jax(name):
    params, grads = _inputs()
    jopt, opt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, st = jopt.init(jp), opt.init(p)
    for g in grads:
        jg, jn = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 2.0)
        tg, n = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 2.0)
        np.testing.assert_allclose(float(n), float(jn), **TOL)
        ju, js = jopt.update(jg, js, jp)
        u, st = opt.update(tg, st, p)
        assert all(x.dtype == torch.float32 for x in u.values())
        jp, p = joptim.apply_updates(jp, ju), optim.apply_updates(p, u)
        for k in SHAPES:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       **TOL, err_msg=k)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == STEPS
    for key in ("mu", "nu", "mom"):
        if key in st:
            assert all(x.dtype == torch.float32 for x in st[key].values())
            for k in SHAPES:
                np.testing.assert_allclose(st[key][k].numpy(),
                                           np.asarray(js[key][k]), **TOL)


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-4),
    lambda m: m.cosine_decay(1e-3, 7),
    lambda m: m.cosine_decay(1e-3, 7, final_frac=0.0),
    lambda m: m.warmup_cosine(1e-3, 3, 10),
    lambda m: m.warmup_cosine(1e-3, 0, 10),
])
def test_schedule_matches_jax(make):
    jf, f = make(joptim), make(optim)
    for step in range(12):
        got = f(torch.tensor(step, dtype=torch.int32))
        want = jf(jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_global_norm_and_clip_match_jax():
    _, grads = _inputs(3)
    g = grads[0]
    jn = joptim.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    n = optim.global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    np.testing.assert_allclose(float(n), float(jn), **TOL)
    for max_norm in (1e-3, 1.0, 1e6):       # clipped, clipped, untouched
        jc, _ = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        c, _ = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        for k in SHAPES:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]),
                                       **TOL)
    c, _ = optim.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1e6)
    assert all(torch.equal(c[k], torch.from_numpy(g[k])) for k in SHAPES)


def test_apply_updates_keeps_the_param_dtype():
    p = {"a": torch.ones(3, dtype=torch.bfloat16)}
    u = {"a": torch.full((3,), 1e-3)}
    out = optim.apply_updates(p, u)
    assert out["a"].dtype == torch.bfloat16
    want = (p["a"].float() + u["a"]).to(torch.bfloat16)
    assert torch.equal(out["a"], want)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_apply_is_update_then_apply_updates_and_consumes_its_inputs(name):
    """``opt.apply`` (the train step's leaf-by-leaf form) gives the bits of
    scaling the gradient, ``update`` and ``apply_updates``, and leaves the
    gradient, the params and the per-leaf state empty."""
    params, grads = _inputs(1)
    opt = OPTIMIZERS[name](optim)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p["b"] = p["b"].to(torch.bfloat16)
    q = {k: v.clone() for k, v in p.items()}
    st, sq = opt.init(p), opt.init(q)
    for i, g in enumerate(grads):
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        scale, _ = optim.clip_scale(tg, 2.0) if i % 2 else (None, None)
        want_g = (tg if scale is None else
                  {k: x * scale.to(x.dtype) for k, x in tg.items()})
        u, st = opt.update(want_g, st, p)
        p = optim.apply_updates(p, u)
        old_q, old_sq = q, sq
        q, sq = opt.apply(dict(tg), sq, q, scale)
        assert not old_q and all(
            not v for v in old_sq.values() if isinstance(v, dict))
        for k in SHAPES:
            assert q[k].dtype == p[k].dtype and torch.equal(q[k], p[k]), k
        assert torch.equal(sq["step"], st["step"])
        for key in ("mu", "nu", "mom"):
            if key in st:
                assert all(torch.equal(sq[key][k], st[key][k])
                           for k in SHAPES)
