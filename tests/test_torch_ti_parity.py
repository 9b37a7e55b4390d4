"""Whole case-study runs of the port against the JAX package, made
deterministic: t_i, the paper's rounds-to-target, is a chaotic function
of the rollout draws, so one seed of each package cannot tell a fault
from variance. Here both packages' ``sample_episode_batches`` are
replaced by twins of one deterministic sampler (a 20-step rollout from
the entry point, greedy except at fixed steps, resampled through a fixed
index table), evaluation is greedy (ε = 0), the codec is None on the
dense plan, and both start from the same JAX-drawn init
(``convert.params_from_numpy``). Nothing random is left, so every
adaptation's t_i must be ``==`` and its reward history equal within f32
rounding, at the paper-DQN cut to d_model 64 and two layers.

Tolerances: R is a discounted sum of table rewards along the greedy
path, so two runs that walk the same paths give R equal up to the order
of an f32 sum of ≤ 20 terms of magnitude ≤ 10: ``R_TOL`` = 1e-4
absolute. The meta-loss history is held at the one-step tolerance of
``test_torch_casestudy.py::test_maml_meta_step_matches`` (rtol = atol =
1e-5) compounded over the rounds run: 1e-5 · t0.

The seeds and round counts below sit on no near-tie: along every greedy
evaluation path of every round of these runs, the port's top two
Q-values are apart by at least 3.3e-4 · |Q| (seed 0), 7.9e-4 · |Q|
(seed 2) and 6.4e-4 · |Q| (the run), 30× or more the 1e-5 · |Q| of an
f32 near-tie. If a change parts the two packages, the failure message
names the round, the state and that gap, so a near-tie can be told from
a fault. (Seed 1's init reaches the target before any training: its
t_i are all 1 and test nothing.)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import dqn as jq  # noqa: E402
from repro.rl import casestudy as jcs  # noqa: E402
from repro.rl import gridworld as jgw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import dqn as qmodel  # noqa: E402
from repro_torch.rl import casestudy as tcs  # noqa: E402
from repro_torch.rl import gridworld as gw  # noqa: E402

CUT = dict(d_model=64, num_layers=2)
CFG = dataclasses.replace(get_arch("paper-dqn"), **CUT)
JCFG = dataclasses.replace(jget_arch("paper-dqn"), **CUT)
#: the settings of ``python -m repro_torch.rl.casestudy`` (Fig. 3)
KW = dict(inner_steps=10, outer_lr=0.01)
#: the steps of a rollout that leave the greedy action: they take action
#: (h + cell index) % 4, so the data explores and the Q-network learns
EXPLORE = (2, 5, 8, 11, 14, 17)
STEPS = 20
R_TOL = 1e-4
META_STEP_TOL = 1e-5
MAX_ROUNDS = 60
SEEDS = (0, 2)
#: the port's own sampler, before the ``studies`` fixture replaces it
PORT_SAMPLER = tcs.sample_episode_batches


def _index_table(n_batches: int, batch_size: int) -> np.ndarray:
    i, j = np.meshgrid(np.arange(n_batches), np.arange(batch_size),
                       indexing="ij")
    return (7 * i + j) % STEPS


def jax_sampler(key, params, cfg, task_id, n_batches, *, batch_size=16,
                epsilon=0.1, episodes=1):
    """Deterministic twin of ``repro.rl.casestudy.sample_episode_batches``
    (``key`` and ``epsilon`` unused; one episode)."""
    pos = jnp.asarray(jgw.ENTRY, jnp.int32)[None]
    out = {"state": [], "action": [], "reward": [], "next_state": []}
    for h in range(STEPS):
        s = jgw.one_hot_state(pos)
        a = jnp.argmax(jq.forward(params, cfg, s)[0], -1).astype(jnp.int32)
        if h in EXPLORE:
            a = ((h + jgw.cell_index(pos)) % 4).astype(jnp.int32)
        pos, r = jgw.step(pos, a, task_id)
        for k, v in zip(out, (s, a, r, jgw.one_hot_state(pos))):
            out[k].append(v[0])
    idx = jnp.asarray(_index_table(n_batches, batch_size))
    return {k: jnp.stack(v)[idx] for k, v in out.items()}


def torch_sampler(generator, params, cfg, task_id, n_batches, *,
                  batch_size=16, epsilon=0.1, episodes=1):
    """The same sampler for ``repro_torch.rl.casestudy``."""
    device = next(iter(params.values())).device
    pos = torch.tensor([gw.ENTRY], device=device)
    out = {"state": [], "action": [], "reward": [], "next_state": []}
    for h in range(STEPS):
        s = gw.one_hot_state(pos)
        a = torch.argmax(qmodel.forward(params, cfg, s), -1)
        if h in EXPLORE:
            a = (h + gw.cell_index(pos)) % 4
        pos, r = gw.step(pos, a, task_id)
        for k, v in zip(out, (s, a, r, gw.one_hot_state(pos))):
            out[k].append(v[0])
    idx = torch.as_tensor(_index_table(n_batches, batch_size), device=device)
    return {k: torch.stack(v)[idx] for k, v in out.items()}


@pytest.fixture(scope="module")
def studies():
    """One case study of each package, built after the samplers are
    patched: the JAX package's round programs look the name up when they
    are traced, at their first call. One torch thread: the runs are
    hundreds of tiny ops, which threads only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcs, "sample_episode_batches", jax_sampler)
        mp.setattr(tcs, "sample_episode_batches", torch_sampler)
        yield (jcs.CaseStudy(cfg=JCFG, **KW),
               tcs.CaseStudy(cfg=CFG, device="cpu", **KW))
    torch.set_num_threads(threads)


def _jax_init(seed: int):
    """The init ``jcs.CaseStudy.run(PRNGKey(seed))`` draws: run splits
    (kmeta, kfl), meta_train splits (kinit, kdata)."""
    kmeta, _ = jax.random.split(jax.random.PRNGKey(seed))
    kinit, _ = jax.random.split(kmeta)
    return jq.init(kinit, JCFG)


def _to_port(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _greedy_path(qfn):
    """(cell, action, q-values) of each step of the greedy episode."""
    pos, out = np.array(gw.ENTRY), []
    for _ in range(STEPS):
        s = np.eye(gw.NUM_CELLS, dtype=np.float32)[gw.cell_index(pos)]
        q = np.asarray(qfn(s[None]))[0]
        a = int(np.argmax(q))
        out.append((tuple(int(v) for v in pos), a, q))
        pos = np.clip(pos + gw.MOVES[a], 0, [gw.GRID_W - 1, gw.GRID_H - 1])
    return out


def _parting(J, T, tid, jinit, tinit, rnd):
    """Where the two packages' greedy paths part after round ``rnd``
    (1-based): the state, both Q-vectors and the port's top-two gap."""
    stacked, _, _ = J.adapt_task(jax.random.PRNGKey(0), tid, jinit,
                                 max_rounds=rnd)
    jp = jax.tree.map(lambda x: x[0], stacked)
    tstacked, _, _ = T.adapt_task(torch.Generator().manual_seed(0), tid,
                                  tinit, max_rounds=rnd)
    tp = {k: v[0] for k, v in tstacked.items()}
    jpath = _greedy_path(lambda s: jq.forward(jp, JCFG, jnp.asarray(s))[0])
    tpath = _greedy_path(
        lambda s: qmodel.forward(tp, CFG, torch.from_numpy(s)).detach())
    for h, ((cell, ja, jqv), (_, ta, tqv)) in enumerate(zip(jpath, tpath)):
        if ja != ta:
            top = np.sort(tqv)[-2:]
            return (f"after round {rnd} the greedy paths part at step {h}, "
                    f"cell {cell}: JAX takes {ja} (Q {jqv}), the port {ta} "
                    f"(Q {tqv}); the port's top-two gap {top[1] - top[0]:.3e}"
                    f" against 1e-5·|Q| = {1e-5 * abs(top[1]):.3e}")
    return f"after round {rnd} the greedy paths agree at every step"


def _assert_adaptation_matches(J, T, tid, jinit, tinit, jres, tres):
    (jt, jh), (tt, th) = jres, tres
    for i, (a, b) in enumerate(zip(jh, th)):
        if abs(a - b) > R_TOL:
            pytest.fail(f"task {tid}: R parts at round {i + 1} (JAX {a}, "
                        f"port {b}); " + _parting(J, T, tid, jinit, tinit,
                                                  i + 1))
    assert (tt, len(th)) == (jt, len(jh)), (tid, jt, tt)


@pytest.mark.parametrize("seed", SEEDS)
def test_whole_adaptations_match(studies, seed):
    """Every task adapts from the same init for up to MAX_ROUNDS rounds."""
    J, T = studies
    jinit = _jax_init(seed)
    tinit = _to_port(jinit)
    ts = []
    for tid in range(gw.NUM_TASKS):
        _, jt, jh = J.adapt_task(jax.random.PRNGKey(0), tid, jinit,
                                 max_rounds=MAX_ROUNDS)
        _, tt, th = T.adapt_task(torch.Generator().manual_seed(0), tid,
                                 tinit, max_rounds=MAX_ROUNDS)
        _assert_adaptation_matches(J, T, tid, jinit, tinit, (jt, jh),
                                   (tt, th))
        ts.append(tt)
    # the runs learn: some tasks hit the target in between, so equal t_i
    # is not the trivial equality of two flat histories
    assert any(1 < t < MAX_ROUNDS for t in ts), ts


def test_whole_run_with_meta_training_matches(studies, monkeypatch):
    """``run`` at t0 = 8: meta-training through the same sampler, then
    every task's adaptation from the meta params."""
    J, T = studies
    seed, t0, max_rounds = 2, 8, 40
    tinit = _to_port(_jax_init(seed))
    monkeypatch.setattr(T, "init_params",
                        lambda generator: {k: v.clone()
                                           for k, v in tinit.items()})
    jres = J.run(jax.random.PRNGKey(seed), t0, max_rounds=max_rounds)
    tres = T.run(torch.Generator().manual_seed(seed), t0,
                 max_rounds=max_rounds)
    tol = META_STEP_TOL * t0
    np.testing.assert_allclose(tres.meta_history, jres.meta_history,
                               rtol=tol, atol=tol)
    assert len(tres.meta_history) == t0
    for tid, (jt, tt, jh, th) in enumerate(zip(
            jres.rounds_per_task, tres.rounds_per_task, jres.fl_histories,
            tres.fl_histories)):
        np.testing.assert_allclose(th, jh, rtol=0, atol=R_TOL,
                                   err_msg=f"task {tid}")
        assert tt == jt, (tid, jres.rounds_per_task, tres.rounds_per_task)
    assert any(1 < t < max_rounds for t in tres.rounds_per_task), \
        tres.rounds_per_task


def test_samplers_are_twins(studies):
    """The two samplers give the same batches from the same params."""
    jinit = _jax_init(0)
    tinit = _to_port(jinit)
    for tid in (0, 3):
        jb = jax_sampler(None, jinit, JCFG, tid, 5)
        tb = torch_sampler(None, tinit, CFG, tid, 5)
        assert tb["state"].shape == (5, 16, gw.NUM_CELLS)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
        assert len(set(tb["action"][0].tolist())) > 1


def _within(count, n, p, sigmas=5.0):
    """``count`` of ``n`` Bernoulli(p) draws lies within ``sigmas``
    standard deviations of n·p."""
    return abs(count - n * p) <= sigmas * np.sqrt(n * p * (1 - p))


def test_rollout_and_resampling_draws_follow_their_distributions(
        monkeypatch):
    """The draws the deterministic runs replace, held to the reference's
    distributions over 10^5 draws each (each count within 5 σ): the
    ε-greedy action is the greedy one with probability 1 − ε + ε/4 and
    each other action with ε/4, in both packages; the minibatch indices
    are uniform over the episode's 20 transitions."""
    n, eps, greedy = 100_000, 0.1, 2
    q = np.zeros((1, 4), np.float32)
    q[0, greedy] = 1.0
    tq = torch.from_numpy(q)
    data = gw.rollout(torch.Generator().manual_seed(0),
                      lambda s: tq.expand(s.shape[0], 4), 0, steps=1,
                      epsilon=eps, batch=n, device="cpu")
    jdata = jgw.rollout(jax.random.PRNGKey(0),
                        lambda s: jnp.broadcast_to(jnp.asarray(q),
                                                   (s.shape[0], 4)),
                        0, steps=1, epsilon=eps, batch=n)
    for actions in (data["action"].numpy(), np.asarray(jdata["action"])):
        counts = np.bincount(actions.ravel(), minlength=4)
        for a in range(4):
            p = 1 - eps + eps / 4 if a == greedy else eps / 4
            assert _within(counts[a], n, p), (a, counts)

    # resampling: the index of each drawn transition, read off its reward
    def numbered_rollout(generator, qnet_fn, task_id, *, steps, epsilon,
                         batch, device):
        shape = (batch, steps)
        idx = torch.arange(batch * steps, dtype=torch.float32).reshape(shape)
        return {"state": torch.zeros(shape + (gw.NUM_CELLS,)),
                "action": torch.zeros(shape, dtype=torch.int64),
                "reward": idx, "next_state": torch.zeros(shape +
                                                         (gw.NUM_CELLS,))}

    monkeypatch.setattr(tcs.gw, "rollout", numbered_rollout)
    params = _to_port(_jax_init(0))
    b = PORT_SAMPLER(torch.Generator().manual_seed(0), params, CFG, 0,
                     n // 16)
    counts = np.bincount(b["reward"].numpy().astype(int).ravel(),
                         minlength=STEPS)
    assert counts.sum() == n and len(counts) == STEPS
    assert all(_within(c, n, 1 / STEPS) for c in counts), counts


def test_init_draws_follow_the_reference_distribution():
    """The port's Q-network init (``qmodel.init`` on a torch generator)
    against the JAX package's (``jq.init`` on a key), at full paper-DQN
    width, 4 draws each: per layer the same shapes, zero biases, weights
    within ±3/√fan_in, and the weights scaled by √fan_in drawn from the
    same law: the two-sample Kolmogorov–Smirnov distance of the pooled
    3.2 M values per side is below its α = 1e-6 critical value,
    sqrt(ln(2/α)/2) · sqrt(2/n) ≈ 2.1e-3 (it reads 7.9e-4)."""
    full, jfull = get_arch("paper-dqn"), jget_arch("paper-dqn")
    ours = [qmodel.init(full, generator=torch.Generator().manual_seed(s),
                        device="cpu") for s in range(4)]
    theirs = [_to_port(jq.init(jax.random.PRNGKey(s), jfull))
              for s in range(4)]
    pooled = []
    for draws in (ours, theirs):
        assert {k: v.shape for k, v in draws[0].items()} == \
            {k: v.shape for k, v in ours[0].items()}
        vals = []
        for p in draws:
            for name, w in p.items():
                if name.endswith(".b"):
                    assert not w.any(), name
                    continue
                z = w.double().numpy().ravel() * np.sqrt(w.shape[0])
                assert np.abs(z).max() <= 3.0 + 1e-5, name
                vals.append(z)
        pooled.append(np.sort(np.concatenate(vals)))
    a, b = pooled
    grid = np.concatenate([a, b])
    ks = np.abs(np.searchsorted(a, grid, side="right") / len(a)
                - np.searchsorted(b, grid, side="right") / len(b)).max()
    assert ks < np.sqrt(np.log(2 / 1e-6) / 2) * np.sqrt(2 / len(a)), ks
    # the truncated N(0, 1)'s standard deviation on [-3, 3]
    for z in pooled:
        assert abs(z.std() - 0.98654) < 2e-3 and abs(z.mean()) < 2e-3
