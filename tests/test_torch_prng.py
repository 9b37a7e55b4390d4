"""The port's threefry draws and the masks built on them against
``jax.random`` and the JAX package's ``core/topology.py``, bit for bit
(``==``): keys, fold-ins, raw bits, uniforms, per-edge survival (dense and
per-edge forms, symmetric and directed graphs), the host dropout stream,
per-agent availability (scalar and per-agent rates), all five
``AgentProcess`` kinds and the host availability stream. Inputs are made
with numpy from seeds."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core import prng, topology  # noqa: E402


def _jkey_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 2**32 - 1])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _jkey_data(jax.random.PRNGKey(seed)))


def test_prng_key_refuses_out_of_range_seeds():
    for seed in (-1, 2**32):
        with pytest.raises(ValueError, match="seed"):
            prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_fold_in_bits_uniform_match_jax(seed):
    """Many data values, edge ids up to 4096² and the uint32 extremes,
    folded into one key; then bits and uniform of every folded key."""
    rng = np.random.default_rng(seed)
    data = np.concatenate([
        np.arange(64), [4096 * 4096 - 1, 4096 * 4096, 2**31, 2**32 - 1],
        rng.integers(0, 4096 * 4096, 256)]).astype(np.uint32)
    jk = jax.random.PRNGKey(seed)
    jfold = jax.vmap(lambda d: jax.random.fold_in(jk, d))(jnp.asarray(data))
    key = prng.PRNGKey(seed)
    fold = prng.fold_in(key, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(fold.numpy(), _jkey_data(jfold))
    jbits = jax.vmap(lambda k: jax.random.bits(k))(jfold)
    np.testing.assert_array_equal(prng.bits(fold).numpy(),
                                  np.asarray(jbits).astype(np.int64))
    ju = jax.vmap(jax.random.uniform)(jfold)
    u = prng.uniform(fold)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_fold_in_broadcasts_a_grid_of_keys():
    """A (R, 1, 2) tensor of round keys folded with (K, H) ids gives the
    (R, K, H) grid the per-round draws use, entry for entry."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 2**20, (5, 3))
    rk = prng.fold_in(prng.PRNGKey(9), torch.arange(4))
    grid = prng.uniform(prng.fold_in(rk[:, None, None, :],
                                     torch.from_numpy(ids)))
    assert grid.shape == (4, 5, 3)
    for r in range(4):
        jr = jax.random.fold_in(jax.random.PRNGKey(9), r)
        want = jax.vmap(lambda e: jax.random.uniform(
            jax.random.fold_in(jr, e)))(jnp.asarray(ids.ravel(), jnp.uint32))
        np.testing.assert_array_equal(grid[r].numpy().ravel(),
                                      np.asarray(want))


def _graphs(K):
    return {"ring": (topology.ring(K), jtopo.ring(K)),
            "small_world": (topology.small_world(K, k=4, seed=1),
                            jtopo.small_world(K, k=4, seed=1)),
            "star": (topology.star(K), jtopo.star(K)),
            "hierarchical": (topology.make("hierarchical", K),
                             jtopo.make("hierarchical", K))}


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("fam", ["ring", "small_world", "star",
                                 "hierarchical"])
def test_survival_mask_dense_and_per_edge_match_jax(fam, p):
    K = 16
    topo, jt = _graphs(K)[fam]
    assert topo.is_symmetric == jt.is_symmetric
    for seed, t in ((0, 0), (5, 3), (11, 1000)):
        key, jkey = topology.survival_key(seed), jtopo.survival_key(seed)
        got = topology.survival_mask(topo.adjacency, p, key, t)
        want = np.asarray(jtopo.survival_mask(jt.adjacency, p, jkey, t))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        # per edge, at the lanes of an (K, H) neighbour table
        rows = np.arange(K)[:, None]
        cols = np.random.default_rng(seed).integers(0, K, (K, 3))
        kw = dict(symmetric=topo.is_symmetric, receivers=rows, senders=cols)
        got_e = topology.survival_mask(K, p, key, t, **kw)
        want_e = np.asarray(jtopo.survival_mask(K, p, jkey, t, **kw))
        np.testing.assert_array_equal(got_e.numpy(), want_e)
    if p == 1.0:
        assert not got.numpy().any()
    if p == 0.0:
        np.testing.assert_array_equal(got.numpy(), topo.adjacency)


def test_survival_mask_draws_many_rounds_at_once():
    topo = topology.small_world(32, k=4, seed=2)
    key = topology.survival_key(4)
    grid = topology.survival_mask(topo.adjacency, 0.3, key,
                                  torch.arange(10, 16))
    assert grid.shape == (6, 32, 32)
    for i, t in enumerate(range(10, 16)):
        np.testing.assert_array_equal(
            grid[i].numpy(),
            topology.survival_mask(topo.adjacency, 0.3, key, t).numpy())


def test_survival_mask_refusals_mirror_jax():
    key = topology.survival_key(0)
    for kw, match in ((dict(receivers=[0, 1]), "senders="),
                      (dict(senders=[0, 1]), "receivers="),
                      (dict(receivers=[0], senders=[1]), "symmetric=")):
        with pytest.raises(ValueError, match=match):
            topology.survival_mask(4, 0.3, key, 0, **kw)
        with pytest.raises(ValueError, match=match):
            jtopo.survival_mask(4, 0.3, jtopo.survival_key(0), 0, **kw)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("fam", ["ring", "star", "hierarchical"])
def test_dropout_stream_matches_jax(fam, p):
    topo, jt = _graphs(12)[fam]
    topo = topo.with_edge_efficiency(2e6)
    jt = jt.with_edge_efficiency(2e6)
    ours = topology.dropout(topo, p, seed=3, rounds=5)
    theirs = jtopo.dropout(jt, p, seed=3, rounds=5)
    for a, b in zip(ours, theirs):
        assert a.name == b.name and a.meta == b.meta
        np.testing.assert_array_equal(a.adjacency, b.adjacency)
        np.testing.assert_array_equal(a.link_class, b.link_class)
        np.testing.assert_array_equal(a.edge_efficiency, b.edge_efficiency)
    gen = topology.dropout(topo, p, seed=3)
    for a in ours:
        np.testing.assert_array_equal(next(gen).adjacency, a.adjacency)
    with pytest.raises(ValueError, match="dropout probability"):
        topology.dropout(topo, 1.0)


def test_graph_process_mirrors_jax():
    for make in (lambda m: m.GraphProcess.static(),
                 lambda m: m.GraphProcess.dropout(0.25, seed=4),
                 lambda m: m.GraphProcess.schedule(np.ones((3, 4, 4), bool))):
        a, b = make(topology), make(jtopo)
        assert repr(a) == repr(b) and a.kind == b.kind and a.p == b.p
    for kw, match in ((dict(kind="fade"), "unknown graph process"),
                      (dict(kind="dropout", p=1.0), "dropout probability"),
                      (dict(kind="schedule", masks=np.ones((4, 4))),
                       "schedule masks")):
        for mod in (topology, jtopo):
            with pytest.raises(ValueError, match=match):
                mod.GraphProcess(**kw)


@pytest.mark.parametrize("per_agent", [False, True])
def test_availability_mask_matches_jax(per_agent):
    K = 24
    rng = np.random.default_rng(5)
    p = (rng.uniform(0, 1, K) if per_agent else 0.35)
    p = np.concatenate([[0.0, 1.0], p[2:]]) if per_agent else p
    for seed, t in ((0, 0), (2, 7), (9, 123)):
        key, jkey = topology.availability_key(seed), jtopo.availability_key(seed)
        got = topology.availability_mask(K, p, key, t)
        want = np.asarray(jtopo.availability_mask(K, p, jkey, t))
        np.testing.assert_array_equal(got.numpy(), want)
        ids = rng.integers(0, K, (5, 3))
        np.testing.assert_array_equal(
            topology.availability_mask(K, p, key, t, agents=ids).numpy(),
            np.asarray(jtopo.availability_mask(K, p, jkey, t, agents=ids)))
    if per_agent:
        grid = topology.availability_mask(K, p, key, torch.arange(50))
        assert grid[:, 0].all() and not grid[:, 1].any()


def _processes(mod, K):
    return {
        "always_on": mod.AgentProcess.always_on(),
        "bernoulli": mod.AgentProcess.bernoulli(0.7, seed=3),
        "straggler": mod.AgentProcess.straggler(K, seed=2),
        "arrival": mod.AgentProcess.arrival(np.arange(K) % 5),
        "departure": mod.AgentProcess.departure(3 + np.arange(K) % 4),
    }


@pytest.mark.parametrize("kind", ["always_on", "bernoulli", "straggler",
                                  "arrival", "departure"])
def test_agent_processes_and_streams_match_jax(kind):
    K = 20
    ours, theirs = _processes(topology, K)[kind], _processes(jtopo, K)[kind]
    assert repr(ours) == repr(theirs) and ours.K == theirs.K
    if kind == "straggler":     # numpy's Pareto draws, host side
        np.testing.assert_array_equal(ours.rates, theirs.rates)
    for t in (0, 2, 6):
        np.testing.assert_array_equal(
            topology.agent_availability(ours, K, t).numpy(),
            np.asarray(jtopo.agent_availability(theirs, K, t)))
    np.testing.assert_array_equal(topology.availability_stream(ours, K, 9),
                                  jtopo.availability_stream(theirs, K, 9))
    np.testing.assert_array_equal(topology.availability_stream(None, K, 3),
                                  jtopo.availability_stream(None, K, 3))


def test_agent_process_refusals_mirror_jax():
    cases = ((dict(kind="nap"), "unknown agent process"),
             (dict(kind="bernoulli", p_active=1.5), "duty cycle"),
             (dict(kind="straggler", rates=np.ones((2, 2))), "non-empty"),
             (dict(kind="straggler", rates=[0.5, 2.0]), "lie in"),
             (dict(kind="arrival", t_join=[]), "t_join"))
    for kw, match in cases:
        for mod in (topology, jtopo):
            with pytest.raises(ValueError, match=match):
                mod.AgentProcess(**kw)
