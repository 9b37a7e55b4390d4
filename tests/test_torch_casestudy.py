"""The slice as a whole: the port's DQN, TD loss, MAML step, FL round and
case study against the JAX package on converted weights (paper-DQN cut to
d_model = 64, two layers) and numpy-made batches; the gridworld exactly;
and no module of the port importing JAX or the JAX package."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import maml as jmaml  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro.core.protocol import ProtocolResult as JResult  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro import comms as jcomms  # noqa: E402
from repro.models import dqn as jq  # noqa: E402
from repro.rl import dqn as jdqn  # noqa: E402
from repro.rl import gridworld as jgw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import federated, maml, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.models import dqn as qmodel  # noqa: E402
from repro_torch.rl import dqn as dqnrl  # noqa: E402
from repro_torch.rl import gridworld as gw  # noqa: E402
from repro_torch.rl.casestudy import CaseStudy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CUT = dict(d_model=64, num_layers=2)
CFG = dataclasses.replace(get_arch("paper-dqn"), **CUT)
JCFG = dataclasses.replace(jget_arch("paper-dqn"), **CUT)
# f32 forward/backward through a 2-layer, 64-wide net: XLA and PyTorch
# sum the matmuls in different orders, a few ulps of O(1) values
TOL = dict(rtol=1e-5, atol=1e-5)


def _jparams(seed=0):
    return jq.init(jax.random.PRNGKey(seed), JCFG)


def _batch(rng, shape):
    """TD transitions with leading ``shape`` axes, numpy."""
    cells = rng.integers(0, gw.NUM_CELLS, shape + (2,))
    eye = np.eye(gw.NUM_CELLS, dtype=np.float32)
    return {"state": eye[cells[..., 0]], "next_state": eye[cells[..., 1]],
            "action": rng.integers(0, 4, shape).astype(np.int32),
            "reward": rng.standard_normal(shape).astype(np.float32)}


def _to_torch(b):
    return {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
                else _to_torch(v)) for k, v in b.items()}


def _assert_close_tree(ours, theirs_nested, **tol):
    theirs = params_from_numpy(jax.tree.map(np.asarray, theirs_nested),
                               device="cpu")
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_allclose(ours[k].detach().numpy(),
                                   theirs[k].numpy(), err_msg=k, **tol)


def test_gridworld_exact():
    for t in range(gw.NUM_TASKS):
        np.testing.assert_array_equal(gw.reward_table(t), jgw.reward_table(t))
    assert gw.TRAJECTORIES == jgw.TRAJECTORIES
    rng = np.random.default_rng(0)
    pos = np.stack([rng.integers(0, gw.GRID_W, 64),
                    rng.integers(0, gw.GRID_H, 64)], -1).astype(np.int32)
    act = rng.integers(0, 4, 64).astype(np.int32)
    for t in range(gw.NUM_TASKS):
        new, r = gw.step(torch.from_numpy(pos), torch.from_numpy(act), t)
        jnew, jr = jgw.step(jnp.asarray(pos), jnp.asarray(act), t)
        np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(
        gw.one_hot_state(torch.from_numpy(pos)).numpy(),
        np.asarray(jgw.one_hot_state(jnp.asarray(pos))))
    rew = rng.standard_normal((4, 20)).astype(np.float32)
    np.testing.assert_allclose(gw.running_reward(torch.from_numpy(rew)).numpy(),
                               np.asarray(jgw.running_reward(jnp.asarray(rew))),
                               rtol=1e-6)


def test_convert_roundtrip_and_forward():
    jp = _jparams()
    p = params_from_numpy(jp, device="cpu")
    assert sorted(p) == ["fc0.b", "fc0.w", "fc1.b", "fc1.w"]
    assert p["fc0.w"].shape == (40, 64) and p["fc1.w"].shape == (64, 4)
    back = params_to_numpy(p)
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          np.asarray(jp[layer][leaf]))
    stacked = jax.tree.map(lambda x: jnp.stack([x, 2 * x, 3 * x]), jp)
    ps = params_from_numpy(stacked, device="cpu")
    assert ps["fc0.w"].shape == (3, 40, 64)
    state = np.eye(40, dtype=np.float32)[:8]
    np.testing.assert_allclose(
        qmodel.forward(p, CFG, torch.from_numpy(state)).numpy(),
        np.asarray(jq.forward(jp, JCFG, jnp.asarray(state))[0]), **TOL)
    init = qmodel.init(CFG, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in p.items()}
    assert float(init["fc0.w"].abs().max()) <= 3.0 / np.sqrt(40) + 1e-6


def test_td_loss_and_grads_match():
    jp, jtp = _jparams(0), _jparams(1)
    b = _batch(np.random.default_rng(1), (32,))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    p, tp = params_from_numpy(jp, device="cpu"), params_from_numpy(jtp, device="cpu")
    tb = _to_torch(b)
    loss = dqnrl.td_loss(p, CFG, tb, target_params=tp)
    jloss = jdqn.td_loss(jp, JCFG, jb, target_params=jtp)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    g = grad(lambda q: dqnrl.td_loss(q, CFG, tb, target_params=tp))(p)
    jg = jax.grad(lambda q: jdqn.td_loss(q, JCFG, jb, target_params=jtp))(jp)
    _assert_close_tree(g, jg, **TOL)


@pytest.mark.parametrize("first_order", [True, False])
def test_maml_meta_step_matches(first_order):
    Q, steps = 3, 3
    jp = _jparams(2)
    rng = np.random.default_rng(2)
    sup, qry = _batch(rng, (Q, steps, 16)), _batch(rng, (Q, 16))
    jsup = {k: jnp.asarray(v) for k, v in sup.items()}
    jqry = {k: jnp.asarray(v) for k, v in qry.items()}
    jsup["target_params"] = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (Q, steps) + x.shape), jp)
    jqry["target_params"] = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (Q,) + x.shape), jp)
    kw = dict(inner_lr=0.05, outer_lr=0.01, inner_steps=steps,
              first_order=first_order)
    jnew, jm = jmaml.maml_meta_step(jdqn.make_loss_fn(JCFG), jp, jsup, jqry,
                                    **kw)
    p = params_from_numpy(jp, device="cpu")
    tsup, tqry = _to_torch(sup), _to_torch(qry)
    tsup["target_params"] = {k: v.expand((Q, steps) + v.shape).clone()
                             for k, v in p.items()}
    tqry["target_params"] = {k: v.expand((Q,) + v.shape).clone()
                             for k, v in p.items()}
    new, m = maml.maml_meta_step(dqnrl.make_loss_fn(CFG), p, tsup, tqry, **kw)
    _assert_close_tree(new, jnew, **TOL)
    np.testing.assert_allclose(float(m["meta_loss"]), float(jm["meta_loss"]),
                               **TOL)
    np.testing.assert_allclose(m["task_losses"].numpy(),
                               np.asarray(jm["task_losses"]), **TOL)


def test_decentralized_fl_round_int8_sparse_matches():
    Kag, steps = 4, 3
    rng = np.random.default_rng(3)
    base = [_jparams(s) for s in range(Kag)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *base)
    b = _batch(rng, (Kag, steps, 16))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jb["target_params"] = jax.tree.map(
        lambda x: jnp.broadcast_to(x[0], (Kag, steps) + x.shape[1:]), jstack)
    jeng = JEngine(jtopo.ring(Kag), codec="int8", plan="sparse-pallas")
    jout, jst = jfed.decentralized_fl_round(
        jdqn.make_loss_fn(JCFG), jstack, jb, jeng, lr=0.05,
        codec_state=jeng.init_state(jstack))
    stack = params_from_numpy(jstack, device="cpu")
    tb = _to_torch(b)
    tb["target_params"] = {k: v[:1].expand((Kag, steps) + v.shape[1:]).clone()
                           for k, v in stack.items()}
    eng = ConsensusEngine(topology.ring(Kag), codec="int8", plan="sparse-pallas")
    out, st = federated.decentralized_fl_round(
        dqnrl.make_loss_fn(CFG), stack, tb, eng, lr=0.05,
        codec_state=eng.init_state(stack))
    # the int8 codec tolerance of tests/test_engine.py (3 quantizer steps
    # of the quantized leaf): a lane may round the other way where SGD
    # left the two packages an ulp apart
    jout_flat = params_from_numpy(jax.tree.map(np.asarray, jout), device="cpu")
    jst_flat = params_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    for k in out:
        atol = 3.0 * float(jout_flat[k].abs().max()) / 127.0
        torch.testing.assert_close(out[k], jout_flat[k], rtol=0, atol=atol)
        torch.testing.assert_close(st[k], jst_flat[k], rtol=0, atol=atol)
    plain = federated.decentralized_fl_round(
        dqnrl.make_loss_fn(CFG), stack, tb, topology.ring(Kag), lr=0.05)
    assert set(plain) == set(stack)


def test_case_study_runs_and_bills_like_jax():
    cs = CaseStudy(cfg=CFG, plan="sparse-pallas", codec="int8",
                   device="cpu", inner_steps=2, fl_local_steps=3, chunk=3)
    assert cs.engine.plan.kind == "sparse"
    res = cs.run(torch.Generator().manual_seed(0), 2, max_rounds=4)
    assert len(res.meta_history) == 2
    assert all(np.isfinite(res.meta_history))
    assert len(res.rounds_per_task) == 6
    assert all(1 <= t <= 4 for t in res.rounds_per_task)
    assert all(len(h) == t for h, t in zip(res.fl_histories,
                                          res.rounds_per_task))
    jres = JResult(t0=2, rounds_per_task=list(res.rounds_per_task),
                   meta_history=[], fl_histories=[],
                   energy_params=jen.paper_calibrated("fig3"), Q=3,
                   cluster_topology=jtopo.clusters(1, 2),
                   codec=jcomms.resolve_codec("int8"))
    assert res.E_total == jres.E_total
    assert res.summary() == jres.summary()


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for name in ("rl/fig4_tradeoff.py", "rl/fig3_energy.py",
                 "launch/async_fleet.py"):
        assert ROOT / "src" / "repro_torch" / name in files, name
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {name}"
