"""The paper's experiments on the port: chunk invariance of whole protocol
runs (``CaseStudy.run``, ``MTLProtocol.run``: every task's t_i, history
and adapted params the same bits at chunk 1, 4 and 8, with samplers that
draw from their generator), the Fig. 4 t0 sweep and the Fig. 3 report
against the JAX package's scripts (``benchmarks/fig4_tradeoff.py``,
``fig3_energy.py`` and ``table2_rounds.py``, loaded by path and run
unchanged), and the twin of ``examples/async_fleet.py`` against the JAX
engine on the same numpy-made params.

Sizes: paper-DQN cut to d_model 64, two layers (as in
``test_torch_casestudy.py``); a 3-task regression network for
``MTLProtocol``; the fleet's own K = 8, 12 rounds."""
import contextlib
import dataclasses
import importlib.util
import io
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import telemetry as jtl  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import ConsensusEngine as JEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.multitask import ClusterNetwork  # noqa: E402
from repro_torch.core.protocol import MTLProtocol, stage_generators  # noqa: E402
from repro_torch.launch import async_fleet  # noqa: E402
from repro_torch.rl import fig3_energy, fig4_tradeoff  # noqa: E402
from repro_torch.rl.casestudy import CaseStudy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(get_arch("paper-dqn"), d_model=64, num_layers=2)
CHUNKS = (1, 4, 8)


def _load(name):
    """A script of ``benchmarks/`` as a module, by its path (unchanged)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _equal_trees(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


# -- C1: whole protocol runs are chunk-invariant ---------------------------------

def test_stage_generators_are_independent_and_reproducible():
    a = stage_generators(torch.Generator().manual_seed(3), 4)
    b = stage_generators(torch.Generator().manual_seed(3), 4)
    draws = [torch.rand(5, generator=g) for g in a]
    assert all(torch.equal(d, torch.rand(5, generator=g))
               for d, g in zip(draws, b))
    assert len({tuple(d.tolist()) for d in draws}) == 4


@pytest.mark.parametrize("r_target,codec", [(-1e9, "int8"), (100.0, None)])
def test_casestudy_run_is_chunk_invariant(r_target, codec):
    """Every task's t_i, reward history and adapted params, and the meta
    history, are the same bits at chunk 1, 4 and 8: at a target every
    task hits in round 1 (on the int8 wire, whose stochastic rounding
    draws from each task's generator too, in the discarded rounds as
    well), and at the default target, which task 0 hits mid-chunk (round
    5; fl_lr 2.0 makes the greedy policy move) while the others run to
    max_rounds."""
    runs = {}
    for chunk in CHUNKS:
        cs = CaseStudy(cfg=CFG, device="cpu", plan="sparse", codec=codec,
                       inner_steps=2, fl_local_steps=3, fl_lr=2.0,
                       r_target=r_target, chunk=chunk)
        res = cs.run(torch.Generator().manual_seed(0), 1, max_rounds=8)
        runs[chunk] = (res, cs.fl_params)
    res1, params1 = runs[1]
    if r_target < 0:
        assert res1.rounds_per_task == [1] * 6
    else:
        assert any(1 < t < 8 and t % 4 for t in res1.rounds_per_task)
        assert max(res1.rounds_per_task) == 8
    for chunk in CHUNKS[1:]:
        res, params = runs[chunk]
        assert res.rounds_per_task == res1.rounds_per_task, chunk
        assert res.meta_history == res1.meta_history, chunk
        assert res.fl_histories == res1.fl_histories, chunk
        for tid in range(6):
            assert _equal_trees(params[tid], params1[tid]), (chunk, tid)


RNG = np.random.default_rng(7)
W1 = (RNG.standard_normal((2, 16)) * 0.5).astype(np.float32)
W2 = (RNG.standard_normal((16, 1)) * 0.5).astype(np.float32)
XQ = torch.from_numpy(RNG.standard_normal((64, 2)).astype(np.float32))
#: per-task query-loss targets: hit in rounds 6, 5 and 4 of 10
GOAL = (0.013, 0.475, 0.58)


def _task_y(task_id, x):
    return torch.sin(x[..., :1] + task_id) + 0.5 * task_id * x[..., 1:2]


def _proto_loss(p, b):
    return ((torch.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2).mean()


def _drawing_protocol(chunk):
    """A 3-task regression network whose init and samplers draw from the
    generator they are given, on the int8 wire (stochastic rounding)."""
    def sample_support(g, task_id, steps):
        x = torch.randn(steps, 16, 2, generator=g)
        return {"x": x, "y": _task_y(task_id, x)}

    def sample_query(g, task_id):
        x = torch.randn(16, 2, generator=g)
        return {"x": x, "y": _task_y(task_id, x)}

    def target_fn(p, task_id):
        loss = _proto_loss(p, {"x": XQ, "y": _task_y(task_id, XQ)})
        return loss < GOAL[task_id], -loss

    def init_fn(g):
        return {"w1": torch.from_numpy(W1) + 0.1 * torch.randn(2, 16,
                                                                generator=g),
                "w2": torch.from_numpy(W2.copy())}

    return MTLProtocol(
        loss_fn=_proto_loss, init_fn=init_fn,
        network=ClusterNetwork(num_tasks=3, devices_per_cluster=2,
                               meta_task_ids=(0,)),
        sample_support=sample_support, sample_query=sample_query,
        target_fn=target_fn, inner_lr=0.05, outer_lr=0.02, fl_lr=0.05,
        inner_steps=3, fl_local_steps=5, codec="int8", chunk=chunk)


def test_mtl_protocol_run_is_chunk_invariant():
    runs = {}
    for chunk in CHUNKS:
        proto = _drawing_protocol(chunk)
        adapted = {}
        adapt = proto.adapt_task

        def keep(generator, task_id, init, *, max_rounds, _adapt=adapt,
                 _out=adapted):
            p, t_i, hist = _adapt(generator, task_id, init,
                                  max_rounds=max_rounds)
            _out[task_id] = p
            return p, t_i, hist

        proto.adapt_task = keep
        res = proto.run(torch.Generator().manual_seed(0), 3, max_rounds=10)
        runs[chunk] = (res, adapted)
    res1, params1 = runs[1]
    assert res1.rounds_per_task == [6, 5, 4]
    for chunk in CHUNKS[1:]:
        res, params = runs[chunk]
        assert res.rounds_per_task == res1.rounds_per_task, chunk
        assert res.meta_history == res1.meta_history, chunk
        assert res.fl_histories == res1.fl_histories, chunk
        for tid in range(3):
            assert _equal_trees(params[tid], params1[tid]), (chunk, tid)


# -- the Fig. 4 sweep, Table II and Fig. 3 against the JAX package's scripts -----

SWEEP = dict(seeds=1, max_rounds=3, plan="sparse", device="cpu", cfg=CFG,
             verbose=False)


def test_fig4_sweep_matches_the_reference_scripts(tmp_path):
    ref_fig4, ref_table2 = _load("fig4_tradeoff"), _load("table2_rounds")
    assert fig4_tradeoff.T0_GRID == ref_fig4.T0_GRID
    assert fig4_tradeoff.PAPER_TABLE_II == ref_fig4.PAPER_TABLE_II
    out = tmp_path / "torch_fig4.json"
    res = fig4_tradeoff.run(t0_grid=(0, 1, 2), out=str(out), **SWEEP)
    data = json.loads(out.read_text())
    assert set(data) == {"rounds", "mean_rounds", "paper_table_ii",
                         "energies", "run"}
    assert data["run"]["plan"] == "sparse"
    assert data["run"]["device"] == "cpu"
    assert list(data["rounds"]) == ["0", "1", "2"]
    for t0, per_seed in data["rounds"].items():
        assert len(per_seed) == 1 and len(per_seed[0]) == 6
        assert all(1 <= t <= 3 for t in per_seed[0])
        assert data["mean_rounds"][t0] == [float(t) for t in per_seed[0]]
        assert all(c == 3 for c in data["run"]["rounds_computed"][t0][0])
    # the reference's energies on the same mean t_i, float64, exactly
    want = {"mean_rounds": data["mean_rounds"], "energies": {}}
    ref_fig4._add_energies(want, (0, 1, 2))
    assert data["energies"] == json.loads(json.dumps(want["energies"]))
    assert res["energies"] == want["energies"]
    assert data["paper_table_ii"] == {str(k): v for k, v in
                                      ref_fig4.PAPER_TABLE_II.items()}
    # Table II's script reads the port's JSON unchanged
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_table2.main(str(out))
    assert "rounds scale-down vs t0=0" in buf.getvalue()
    # a subset grid: the same t_i at the t0 it shares
    sub = fig4_tradeoff.run(t0_grid=(2,), out=str(tmp_path / "sub.json"),
                            **SWEEP)
    assert sub["rounds"]["2"] == data["rounds"]["2"]


def test_fig4_partial_snapshot_has_the_reference_keys(tmp_path):
    ref_fig4 = _load("fig4_tradeoff")
    rounds = {0: [[5, 7, 2, 9, 1, 3]], 42: [], 210: [[1, 2, 3, 4, 5, 6]]}
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    fig4_tradeoff._save_partial(rounds, (0, 42, 210), str(ours))
    ref_fig4._save_partial(rounds, (0, 42, 210), str(theirs))
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())


@pytest.mark.parametrize("mean_210,mean_0", [
    (fig4_tradeoff.PAPER_TABLE_II[210], fig4_tradeoff.PAPER_TABLE_II[0]),
    ([1.0, 3.5, 8.0, 400.0, 2.25, 17.0], [400.0] * 6),
])
def test_fig3_report_equals_the_reference(mean_210, mean_0):
    ref_fig3 = _load("fig3_energy")
    with contextlib.redirect_stdout(io.StringIO()) as ours:
        got = fig3_energy.report(mean_210, mean_0)
    with contextlib.redirect_stdout(io.StringIO()) as theirs:
        want = ref_fig3.report(mean_210, mean_0)
    assert got == want
    assert ours.getvalue() == theirs.getvalue()


# -- the async fleet twin --------------------------------------------------------

@pytest.mark.parametrize("plan", ["auto", "sparse"])
@pytest.mark.parametrize("which", range(5))
def test_async_fleet_matches_the_jax_engine(which, plan):
    """Each of the example's five fleets on the same numpy-made (8, 32)
    params, on the example's plan (``auto``: dense at K = 8) and on the
    sparse plan the card runs: every round's n_active, max_age and joules
    ``==`` (they depend only on the threefry draws, bit-exact between the
    packages), mixed params within 1e-5 absolute (f32 sums in other
    orders, a few ulps of |w| ≤ 4). The int8 wire rounds to nearest;
    where an ulp flipped a lane, the two would part by a quantizer step
    (max |w| / 127 ≈ 0.03), far outside this gate."""
    label, agents = async_fleet.processes()[which]
    stacked = async_fleet.fleet_params("cpu")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        _, mixed, tel = async_fleet.run(agents, label, stacked, plan=plan)
    assert printed.getvalue().strip().startswith(label)
    kw = ({"agents": _jax_process(which), "tau": 3, "staleness_decay": 0.9}
          if agents is not None else {})
    jeng = JEngine(jtopo.ring(async_fleet.K), codec="int8",
                   plan={"auto": "auto", "sparse": "sparse-pallas"}[plan],
                   **kw)
    jt = jtl.Telemetry()
    jmixed, _ = jeng.scan_rounds({"w": jnp.asarray(stacked["w"].numpy())},
                                 rounds=async_fleet.ROUNDS, telemetry=jt)
    ev, jev = tel.events(driver="consensus"), jt.events(driver="consensus")
    assert len(ev) == len(jev) == async_fleet.ROUNDS
    for f in ("n_active", "max_age", "joules"):
        assert [e[f] for e in ev] == [e[f] for e in jev], f
    assert tel.joules(driver="consensus") == jt.joules(driver="consensus")
    np.testing.assert_allclose(mixed["w"].numpy(), np.asarray(jmixed["w"]),
                               atol=1e-5, rtol=0)


def _jax_process(which):
    """The JAX example's AgentProcess of fleet ``which``."""
    K, R = async_fleet.K, async_fleet.ROUNDS
    return (None,
            jtopo.AgentProcess.bernoulli(0.6, seed=1),
            jtopo.AgentProcess.straggler(K, scale=0.3, seed=1),
            jtopo.AgentProcess.arrival(np.arange(K) * 2),
            jtopo.AgentProcess.departure(np.full(K, R - 4)))[which]
