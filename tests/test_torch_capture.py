"""Captured round programs against ``scanloop.uncaptured()`` on the card
(marked ``gpu``; they skip where there is no CUDA card). The same drivers,
once replaying CUDA graphs and once eager, must give the same bits:
params, codec state, t_i, history, the generator's final state, telemetry
rows; the kernel launches inside the graphs are counted through the
replays; a capture the graph refuses raises by name. The CPU side of the
program layer, against the JAX package, is ``tests/test_torch_scanloop.py``.

On the card: ``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_capture.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import federated, maml, scanloop, topology  # noqa: E402
from repro_torch.core.engine import ConsensusEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

K, D = 8, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: rounds are captured only there")
    return torch.device("cuda")


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _fl_case(device):
    g = torch.Generator(device=device).manual_seed(3)
    target = torch.randn((D, 1), generator=g, device=device)

    def loss(p, b):
        return ((b["x"] @ p["w"] - b["x"] @ target) ** 2).mean()

    def sample(generator, _t):
        return {"x": torch.randn((K, 2, 4, D), generator=generator,
                                 device=device)}

    def target_fn(sp):
        m = ((sp["w"] - target) ** 2).mean()
        return m < 0.05, m

    params = {"w": torch.zeros((K, D, 1), device=device)}
    return loss, sample, target_fn, params


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("dyn", ["static", "fading", "sleeping"])
def test_fl_driver_captured_equals_uncaptured(cuda, codec, dyn):
    loss, sample, target_fn, params = _fl_case(cuda)
    kw = {"static": {},
          "fading": dict(graph=topology.GraphProcess.dropout(0.3, seed=1)),
          "sleeping": dict(agents=topology.AgentProcess.bernoulli(0.7),
                           tau=2, staleness_decay=0.9)}[dyn]
    eng = ConsensusEngine(topology.ring(K), codec=codec, plan="sparse", **kw)
    own = "quant_consensus_pop" if codec else "consensus_update_pop"

    def run(chunk):
        tel = Telemetry()
        g = torch.Generator(device=cuda).manual_seed(7)
        before = getattr(ops, own).launches
        p, t_i, hist, st = federated.run_fl_until_scan(
            loss, params, sample, eng, 0.2, target_fn=target_fn,
            max_rounds=12, generator=g, chunk=chunk, telemetry=tel,
            return_state=True)
        n = getattr(ops, own).launches - before
        return (p, t_i, hist, st, g.get_state(),
                tel.events(live_only=False)), n

    for chunk in (8, 1):
        got, n = run(chunk)
        with scanloop.uncaptured():
            want, n_eager = run(chunk)
        assert _same(got, want)
        computed = min(-(-got[1] // chunk) * chunk, 12)
        assert n == n_eager == computed       # one leaf: one launch a round
    recs = [r for r in scanloop.registered_programs()
            if r.cache_key is not None and r.cache_key[4] is eng]
    assert len(recs) == 1 and recs[0].captured and recs[0].in_place
    assert recs[0].launches_per_replay["variant 0"][own] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["eval_every_2", "host_target"])
def test_fl_driver_variants_captured_equal_uncaptured(cuda, case,
                                                     monkeypatch):
    """The variants captured in the middle of a run: ``eval_every=2``
    (the skip round's graph beside the evaluating one) and a target that
    reads the host (``update`` and ``commit`` graphs around it, the
    program never cached), on the int8 wire with fading links."""
    loss, sample, target_fn, params = _fl_case(cuda)
    if case == "host_target":
        def target(sp):
            _, m = target_fn(sp)
            return float(m) < 0.05, m
    else:
        target = target_fn
    made = []
    build = scanloop.donating_graph
    monkeypatch.setattr(scanloop, "donating_graph", lambda *a, **kw: (
        made.append(build(*a, **kw)) or made[-1]))
    eng = ConsensusEngine(topology.ring(K), codec="int8", plan="sparse",
                          graph=topology.GraphProcess.dropout(0.3, seed=1))
    every = 2 if case == "eval_every_2" else 1

    def run(chunk):
        tel = Telemetry()
        g = torch.Generator(device=cuda).manual_seed(7)
        before = ops.quant_consensus_pop.launches
        p, t_i, hist, st = federated.run_fl_until_scan(
            loss, params, sample, eng, 0.2, target_fn=target,
            max_rounds=12, generator=g, chunk=chunk, telemetry=tel,
            eval_every=every, return_state=True)
        n = ops.quant_consensus_pop.launches - before
        return (p, t_i, hist, st, g.get_state(),
                tel.events(live_only=False)), n

    scanloop.clear_program_cache()
    for chunk in (8, 1):
        got, n = run(chunk)
        with scanloop.uncaptured():
            want, n_eager = run(chunk)
        assert _same(got, want)
        assert 1 < got[1] < 8            # the target hits mid-chunk
        assert n == n_eager == min(-(-got[1] // chunk) * chunk, 12)
    recs = [p.record for p in made if p.record.replays]
    assert recs and all(r.captured and r.captures == 2 for r in recs)
    if case == "host_target":
        assert all(r.host_fns == ("target_fn",) and r.cache_key is None
                   for r in recs)
    else:
        assert len(recs) == 1 and recs[0].cache_key is not None


@pytest.mark.gpu
def test_donation_audit_catches_a_copied_carry_and_a_moved_buffer(
        cuda, monkeypatch):
    """JX3 fails on real replays: a program that hands its carry out as a
    copy is flagged, and a replay refuses a buffer moved away from the
    address its graph writes."""
    from repro_torch.analysis import programs
    loss, sample, target_fn, params = _fl_case(cuda)
    eng = ConsensusEngine(topology.ring(K), codec="int8", plan="sparse")

    def run():
        return federated.run_fl_until_scan(
            loss, params, sample, eng, 0.2, target_fn=target_fn,
            max_rounds=4, chunk=4,
            generator=torch.Generator(device=cuda).manual_seed(7))

    def rec():
        return [p.record for k, p in scanloop._program_cache.items()
                if k[4] is eng]

    scanloop.clear_program_cache()
    run()
    assert rec()[0].in_place and programs.audit_programs(rec()) == []
    scanloop.clear_program_cache()
    hand_out = scanloop.Program._hand_out
    monkeypatch.setattr(scanloop.Program, "_hand_out",
                        lambda self, v, args: scanloop.own(
                            hand_out(self, v, args)))
    run()
    assert rec()[0].in_place is False
    assert [f.rule for f in programs.audit_programs(rec())] == ["JX3"]
    monkeypatch.undo()
    scanloop.clear_program_cache()
    run()
    prog = scanloop._program_cache[rec()[0].cache_key]
    carry = next(iter(prog._carry.values()))
    carry[0].set_(carry[0].clone())
    with pytest.raises(RuntimeError, match="moved away"):
        run()
    assert rec()[0].in_place is False
    scanloop.clear_program_cache()


@pytest.mark.gpu
def test_byte_cap_drops_a_program_after_its_driver_call(cuda):
    """Under a byte cap below a program's measured ``held_bytes`` the
    driver still replays it, and the cache lets it go after the call."""
    loss, sample, target_fn, params = _fl_case(cuda)
    eng = ConsensusEngine(topology.ring(K), codec="int8", plan="sparse")
    scanloop.clear_program_cache()
    scanloop.reset_cache_stats()
    cap = scanloop.PROGRAM_CACHE_BYTES
    try:
        scanloop.PROGRAM_CACHE_BYTES = 1
        outs = []
        for _ in range(2):
            g = torch.Generator(device=cuda).manual_seed(7)
            outs.append(federated.run_fl_until_scan(
                loss, params, sample, eng, 0.2, target_fn=target_fn,
                max_rounds=6, chunk=3, generator=g))
        stats = scanloop.cache_stats()
        assert (stats["size"], stats["inserts"], stats["evictions"],
                stats["held_bytes"]) == (0, 2, 2, 0)
        assert stats["trace_counts"]["fl_chunk"] == 2
        assert _same(outs[0], outs[1])
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
        scanloop.clear_program_cache()


@pytest.mark.gpu
def test_maml_captured_equals_uncaptured(cuda):
    def mloss(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()

    def tasks(generator, _t):
        x = torch.randn((2, 3, 4, D), generator=generator, device=cuda)
        q = torch.randn((2, 4, D), generator=generator, device=cuda)
        return ({"x": x, "y": x.sum(-1, keepdim=True)},
                {"x": q, "y": q.sum(-1, keepdim=True)})

    def run():
        g = torch.Generator(device=cuda).manual_seed(1)
        p, h = maml.maml_train_scan(
            mloss, {"w": torch.zeros((D, 1), device=cuda)}, tasks, rounds=6,
            inner_lr=0.1, outer_lr=0.1, inner_steps=3, chunk=4, generator=g)
        return p, h, g.get_state()

    got = run()
    with scanloop.uncaptured():
        want = run()
    assert _same(got, want)


@pytest.mark.gpu
def test_case_study_captured_equals_uncaptured(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.rl.casestudy import CaseStudy
    cfg = dataclasses.replace(get_arch("paper-dqn"), d_model=16,
                              num_layers=2)
    cs = CaseStudy(cfg=cfg, codec="int8", device="cuda", inner_steps=2,
                   fl_local_steps=2, chunk=4, r_target=1e9,
                   availability=topology.AgentProcess.bernoulli(0.75),
                   tau=2, dropout_p=0.3, telemetry=Telemetry())

    def run():
        cs.telemetry.reset()
        res = cs.run(torch.Generator(device=cuda).manual_seed(0), 2,
                     max_rounds=5)
        return (res.rounds_per_task, res.meta_history, res.fl_histories,
                cs.fl_params, cs.fl_codec_state, cs.fl_async_state,
                [d.tolist() for d in cs.fl_delivered.values()],
                cs.telemetry.events(live_only=False))

    got = run()
    with scanloop.uncaptured():
        want = run()
    assert _same(got, want)
    assert cs._meta_program.record.captured
    assert all(p.record.captured for p in cs._fl_programs.values())


@pytest.mark.gpu
def test_refused_capture_raises_by_name(cuda):
    prog = scanloop.donating_graph(
        lambda v: ((v * v.sum().item(),), v.sum()), donate_argnums=(0,),
        name="refused")
    with pytest.raises(RuntimeError, match="refused.*_local_scalar_dense"):
        prog(torch.ones(4, device=cuda))
