"""Captured round programs against ``scanloop.uncaptured()`` on the card
(marked ``gpu``; they skip where there is no CUDA card). The same drivers,
once replaying CUDA graphs and once eager, must give the same bits:
params, codec state, t_i, history, the generator's final state, telemetry
rows; the kernel launches inside the graphs are counted through the
replays; a capture the graph refuses raises by name; a K = 256 program
above the default byte cap is kept and run eagerly, and hit by the next
call (F4); ``ConsensusEngine.scan_rounds`` replays its own captured round
program on every plan without a mesh; the LM launchers' programs
(serving's prefill and decode, training's step and federated round, at a
reduced size) are captured ``==`` uncaptured, above any byte cap, their
kept params read by reference; the meshed engines' three programs (the
FL driver's cached round, ``scan_rounds``' held round and
``train_federated(mesh=)``'s round) on an NCCL group of world size 1 are
captured ``==`` uncaptured and ``==`` the runs without a mesh, and a
collective recorder reads the same collectives of a captured run as of
an uncaptured one. The CPU side of the program layer, against the JAX
package, is ``tests/test_torch_scanloop.py`` and
``tests/test_torch_engine_program.py``; the meshed programs on gloo
groups of 2 and 4 ranks, ``tests/test_torch_mesh_programs.py``.

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
    recs = [p.record for p in made if p.record.captures]
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
    """Under a byte cap below a program's carry the program is never
    captured: its cache entry stays, under the byte rule, and the second
    driver call hits it and runs the rounds eagerly, with the same bits."""
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
        assert (stats["size"], stats["hits"], stats["inserts"],
                stats["evictions"], stats["held_bytes"],
                stats["eager_by_byte_rule"]) == (1, 1, 1, 0, 0, 1)
        assert stats["trace_counts"]["fl_chunk"] == 1
        (prog,) = scanloop._program_cache.values()
        assert prog.record.captures == 0
        assert prog.record.why_uncaptured == scanloop.OVER_BYTE_CAP
        assert _same(outs[0], outs[1])
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap
        scanloop.clear_program_cache()


def _wide_fl_case(device, n):
    """K = 256 agents of ``n`` params each: a regression pull toward seeded
    targets, sampled inside the round (the sampler passes the probe)."""
    KW = 256
    g = torch.Generator(device=device).manual_seed(5)
    target = torch.randn((n,), generator=g, device=device)

    def loss(p, b):
        return 0.5 * (p["w"] - b["w"]).square().sum()

    def sample(generator, _t):
        return {"w": target + 0.1 * torch.randn(
            (KW, 1, n), generator=generator, device=device)}

    def target_fn(sp):
        m = (sp["w"] - target).square().mean()
        return m < -1.0, m

    return loss, sample, target_fn, {"w": torch.zeros((KW, n),
                                                      device=device)}


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "int8"])
def test_k256_program_above_the_default_cap_is_kept_eager(cuda, codec):
    """F4: at the default 1 GiB cap a K = 256 program too large to keep
    (int8 with error feedback: its carry alone, 1.84 GB, is above the
    cap, so it is never captured; f32: captured once, measured above the
    cap, then eager) stays cached. The second ``run_fl_until_scan`` call
    hits it and captures nothing, and both calls are ``==``
    ``uncaptured()`` on params, codec state, t_i, history and the
    generator."""
    assert scanloop.PROGRAM_CACHE_BYTES == 1 << 30
    loss, sample, target_fn, params = _wide_fl_case(cuda, 900_000)
    eng = ConsensusEngine(topology.small_world(256, k=4, seed=1),
                          codec=codec, plan="sparse")
    scanloop.clear_program_cache()
    scanloop.reset_cache_stats()

    def run():
        g = torch.Generator(device=cuda).manual_seed(9)
        p, t_i, hist, st = federated.run_fl_until_scan(
            loss, params, sample, eng, 0.3, target_fn=target_fn,
            max_rounds=3, chunk=3, generator=g, return_state=True)
        torch.cuda.synchronize()
        return p, t_i, hist, st, g.get_state()

    try:
        got = [run()]
        (prog,) = scanloop._program_cache.values()
        first = (prog.record.captures, dict(scanloop.TRACE_COUNTS))
        got.append(run())
        stats = scanloop.cache_stats()
        assert (stats["hits"], stats["misses"], stats["inserts"],
                stats["evictions"]) == (1, 1, 1, 0)
        assert (prog.record.captures, dict(scanloop.TRACE_COUNTS)) == first
        assert prog.record.captures == (0 if codec else 1)
        assert prog.record.why_uncaptured == scanloop.OVER_BYTE_CAP
        assert prog.record.held_bytes == 0 and stats["held_bytes"] == 0
        assert prog.record.over_cap_bytes > scanloop.PROGRAM_CACHE_BYTES
        with scanloop.uncaptured():
            want = run()
        assert _same(got[0], want) and _same(got[1], want)
    finally:
        scanloop.clear_program_cache()


def _scan_case(device, case):
    kw = {"plan": "sparse"}
    gen = tel = None
    if case == "lockstep_int8":
        kw.update(codec="int8")
    elif case == "fading_f32_generator":
        kw.update(graph=topology.GraphProcess.dropout(0.3, seed=1))
        gen = 7
    elif case == "fading_int4_sharded_generator":
        kw.update(codec="int4", plan="sharded", num_blocks=4,
                  graph=topology.GraphProcess.dropout(0.3, seed=1))
        gen = 8
    elif case == "async_int8_tau3":
        kw.update(codec="int8", agents=topology.AgentProcess.bernoulli(
            0.7, seed=2), tau=3, staleness_decay=0.9)
        tel = "buffered"
    elif case == "streaming_int8_distributed":
        kw.update(codec="int8", plan="distributed",
                  graph=topology.GraphProcess.dropout(0.3, seed=1))
        tel = "streaming"
    elif case == "dense_int8_fading":
        kw.update(codec="int8", plan="dense",
                  graph=topology.GraphProcess.dropout(0.3, seed=1))
        tel = "buffered"
    eng = ConsensusEngine(topology.small_world(K, k=4, seed=1), **kw)
    return eng, gen, tel


SCAN_CASES = ["lockstep_int8", "fading_f32_generator",
              "fading_int4_sharded_generator", "async_int8_tau3",
              "streaming_int8_distributed", "dense_int8_fading"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_rounds_captured_equals_uncaptured(cuda, case):
    """``scan_rounds`` replaying its captured round program ``==`` the
    same rounds under ``uncaptured()``: params, codec state, the
    generator's final state, every telemetry row and the B1/B2 launches;
    a second call replays the held program (no capture) from a fresh
    ``AsyncState``; JX3 and JX5 hold on the replays."""
    from repro_torch.analysis import programs
    eng, gen, mode = _scan_case(cuda, case)
    x = {"w": torch.randn((K, 3, 40), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda),
        "b": torch.randn((K, 7), device=cuda)}
    saved = {k: v.clone() for k, v in x.items()}

    def run():
        tel = None if mode is None else Telemetry(mode=mode)
        g = (None if gen is None
             else torch.Generator(device=cuda).manual_seed(gen))
        before = scanloop.launch_counts()
        p, st = eng.scan_rounds(x, generator=g, rounds=5, t0=3,
                                telemetry=tel)
        torch.cuda.synchronize()
        after = scanloop.launch_counts()
        return ((p, st, None if g is None else g.get_state(),
                 None if tel is None else tel.events(live_only=False)),
                {n: after[n] - before[n] for n in after})

    got, n = run()
    again, n2 = run()
    with scanloop.uncaptured():
        want, n_eager = run()
    assert _same(got, want) and _same(again, want)
    # one launch a leaf a round (a block a leaf a round sharded), of B1
    # on the int wires and B2 otherwise; none on the dense plan
    kind = eng.plan.kind
    per = 0 if kind == "dense" else 2 * 5 * eng.plan.num_blocks
    own = "quant_consensus_pop" if eng.codec is not None \
        else "consensus_update_pop"
    assert n == n2 == n_eager == {k: per if k == own else 0 for k in n}
    assert all(torch.equal(x[k], saved[k]) for k in x)   # caller's intact
    recs = eng.program_records()
    if mode == "streaming":
        assert recs == []                    # built per call, never held
        return
    (rec,) = recs
    # the capture's call runs eagerly before it; the other 9 rounds replay
    assert rec.captured and (rec.captures, rec.replays) == (1, 9)
    assert rec.in_place and programs.audit_programs(recs) == []
    assert rec.async_argnums == ((0,) if eng.agents is not None else ())
    assert scanloop.cache_stats()["scan_rounds_held_bytes"] >= \
        rec.held_bytes > 0


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


# -- the LM launchers' programs -------------------------------------------------

LM_FAMILIES = {"dense": "h2o-danube-3-4b", "moe": "qwen2-moe-a2.7b",
               "vlm": "chameleon-34b", "hybrid": "recurrentgemma-9b",
               "ssm": "xlstm-125m", "encdec": "whisper-large-v3"}


def _lm_cfg(family, **change):
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(LM_FAMILIES[family]),
                  num_layers=3 if family == "hybrid" else 2)
    return dataclasses.replace(cfg, **change)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", list(LM_FAMILIES))
def test_serve_captured_equals_uncaptured(cuda, family, dtype):
    """``serve``'s prefill and decode programs (a 72-token prompt past the
    64-token window, 6 tokens): captured once each and replayed, the
    tokens, the prefill's logits and the final caches ``==`` the same
    call under ``uncaptured()``; the kernels' launches by phase the same
    (B3/B4 inside the prefill's graph, none in decode)."""
    from repro_torch.launch.serve import serve
    cfg = _lm_cfg(family, dtype=dtype)

    def run():
        return serve(cfg, batch=2, prompt_len=72, gen=6, device="cuda",
                     verbose=False)

    got = run()
    with scanloop.uncaptured():
        want = run()
    assert _same((got.tokens, got.last_logits, got.caches),
                 (want.tokens, want.last_logits, want.caches))
    assert got.launches == want.launches
    assert not any(got.launches["decode"].values())
    pre, dec = got.programs["prefill"], got.programs["decode"]
    assert (pre.captures, pre.replays, dec.captures, dec.replays) == \
        (1, 0, 1, 4)
    assert pre.held_bytes > 0 and want.programs["decode"].eager_calls == 5


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "hybrid", "encdec", "ssm"])
def test_train_standard_captured_equals_uncaptured(cuda, family):
    """``train_standard``'s step program with remat on (the blocks'
    recompute, B3/B4's plain-VJP backward inside the graph): 3 steps'
    losses and the final params ``==`` uncaptured; the launches too."""
    from repro_torch.launch import train
    cfg = _lm_cfg(family, remat=True)

    def run():
        before = scanloop.launch_counts()
        with scanloop.built_programs() as recs:
            p, h = train.train_standard(cfg, steps=3, batch=2, seq=32,
                                        lr=1e-3, device="cuda")
        after = scanloop.launch_counts()
        return p, h, {k: after[k] - before[k] for k in after}, recs

    p, h, n, (rec,) = run()
    with scanloop.uncaptured():
        p0, h0, n0, _ = run()
    assert _same((p, h, n), (p0, h0, n0))
    assert (rec.captures, rec.replays) == (1, 2) and rec.in_place


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "int8"])
def test_train_federated_captured_equals_uncaptured(cuda, codec):
    """``train_federated``'s round program on the sparse plan, links
    fading and agents asleep, buffered telemetry, 3 rounds at chunk 2:
    the population, the codec state, the losses, the rows and the
    launches (B1 or B2 once a leaf a round, through the replays)
    ``==`` uncaptured."""
    from repro_torch.launch import train
    cfg = _lm_cfg("dense")
    own = "quant_consensus_pop" if codec else "consensus_update_pop"

    def run():
        tel = Telemetry()
        before = getattr(ops, own).launches
        with scanloop.built_programs() as recs:
            p, h, _, st = train.train_federated(
                cfg, rounds=3, agents=4, tasks=2, local_steps=1, batch=1,
                seq=16, lr=1e-3, consensus_plan="sparse", codec=codec,
                dropout_p=0.3, chunk=2, tau=2,
                availability=topology.AgentProcess.bernoulli(0.7, seed=1),
                telemetry=tel, device="cuda", return_state=True)
        return (p, h, st, tel.events(live_only=False),
                getattr(ops, own).launches - before), recs

    got, (rec,) = run()
    with scanloop.uncaptured():
        want, _ = run()
    assert _same(got, want)
    assert got[-1] == 3 * len(got[0])
    assert (rec.captures, rec.replays) == (1, 2) and rec.in_place


@pytest.mark.gpu
def test_launcher_programs_capture_above_the_byte_cap_and_keep_by_reference(
        cuda):
    """At a 1-byte cap a launcher program is still captured (the byte
    rule holds only programs kept across calls); a replay handed another
    tensor for its kept argument is refused by name, before any copy."""
    cap = scanloop.PROGRAM_CACHE_BYTES
    try:
        scanloop.PROGRAM_CACHE_BYTES = 1
        prog = scanloop.donating_graph(
            lambda w, c, x: ((c + x @ w,), (x @ w).sum()),
            donate_argnums=(1,), keep_argnums=(0,), name="kept_card")
        w = torch.randn(8, 8, device=cuda)
        c, x = torch.zeros(8, device=cuda), torch.ones(8, device=cuda)
        (c,), _ = prog(w, c, x)
        (c,), _ = prog(w, c, x)
        assert prog.record.captured and prog.record.replays == 1
        assert torch.equal(c, 2 * (x @ w))
        # the carry and the clone of x; the kept w is the caller's
        assert prog.record.held_bytes == 2 * 8 * 4 + prog._pool_bytes
        w2 = w.clone()
        with pytest.raises(RuntimeError, match="'kept_card'.*kept argument"):
            prog(w2, c, x)
        assert torch.equal(w2, w)
    finally:
        scanloop.PROGRAM_CACHE_BYTES = cap


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-position agent mesh over an NCCL group of world size 1 (one
    card runs no more); the group's communicator set up before the test,
    the cached programs dropped before the group is destroyed."""
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"), backend="nccl")
    try:
        torch.distributed.all_reduce(torch.zeros(1, device=cuda))
        yield mesh_lib.make_agent_mesh()
    finally:
        scanloop.clear_program_cache()
        mesh_lib.destroy_local_group()


def _without_disagreement(out):
    """``out`` with its telemetry rows (its last item) stripped of the
    disagreement, which a meshed engine sums in another order than one
    process (held to its tolerance by the gloo tests)."""
    *head, events = out
    return (*head, [{k: v for k, v in e.items() if k != "disagreement"}
                    for e in events])


def _recorded(fn):
    from repro_torch.analysis.costmodel import CollectiveRecorder
    with CollectiveRecorder() as rec:
        out = fn()
    return out, rec.records


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "int8"])
def test_meshed_fl_driver_captured_equals_uncaptured(cuda, nccl_mesh, codec):
    """The meshed FL driver at NCCL world size 1 (sharded, one block,
    fading links, buffered telemetry): its cached program is captured on
    the first call and replayed by the second (a hit), with the sampler
    and ``target_fn`` inside; both calls ``==`` ``uncaptured()`` and the
    run without a mesh, and the collectives a recorder reads of a
    captured call (one population gather a round, two all-reduces a row)
    ``==`` those of an uncaptured one."""
    loss, sample, target_fn, params = _fl_case(cuda)
    fading = dict(graph=topology.GraphProcess.dropout(0.3, seed=1))
    eng = ConsensusEngine(topology.ring(K), codec=codec, plan="sharded",
                          mesh=nccl_mesh, **fading)
    alone = ConsensusEngine(topology.ring(K), codec=codec, plan="sharded",
                            **fading)
    assert eng.local_rows == slice(0, K)

    def run(engine):
        g = torch.Generator(device=cuda).manual_seed(5)
        tel = Telemetry()
        p, t_i, hist, st = federated.run_fl_until_scan(
            loss, params, sample, engine, 0.1, target_fn=target_fn,
            max_rounds=6, chunk=3, generator=g, return_state=True,
            telemetry=tel)
        return (p, t_i, hist, st, g.get_state(),
                tel.events(live_only=False))

    got = [_recorded(lambda: run(eng)) for _ in range(2)]
    with scanloop.uncaptured():
        want = _recorded(lambda: run(eng))
    ref = run(alone)
    for out, records in got:
        assert _same(out, want[0])
        assert _same(_without_disagreement(out), _without_disagreement(ref))
        assert records == want[1] and records
        assert sum(r.kind == "allgather_" for r in records) == 6
    (rec,) = [r for r in scanloop.registered_programs()
              if r.cache_key is not None and r.cache_key[4] is eng]
    assert rec.captured and rec.host_fns == () and rec.in_place
    assert rec.group_backend == "nccl" and rec.collectives_per_replay


@pytest.mark.gpu
def test_meshed_scan_rounds_captured_equals_uncaptured(cuda, nccl_mesh):
    """``scan_rounds`` on a meshed int8 engine at NCCL world size 1 with
    buffered telemetry: the engine's held program captured, replayed by
    a second call, ``==`` ``uncaptured()`` and the engine without a mesh;
    the recorded collectives ``==``."""
    fading = dict(graph=topology.GraphProcess.dropout(0.3, seed=1))
    eng = ConsensusEngine(topology.ring(K), codec="int8", plan="sharded",
                          mesh=nccl_mesh, **fading)
    alone = ConsensusEngine(topology.ring(K), codec="int8", plan="sharded",
                            **fading)
    x = {"w": torch.randn((K, D), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)}

    def run(engine):
        tel = Telemetry()
        g = torch.Generator(device=cuda).manual_seed(1)
        p, st = engine.scan_rounds(x, rounds=4, generator=g, telemetry=tel)
        return p, st, g.get_state(), tel.events(live_only=False)

    got = [_recorded(lambda: run(eng)) for _ in range(2)]
    with scanloop.uncaptured():
        want = _recorded(lambda: run(eng))
    ref = run(alone)
    for out, records in got:
        assert _same(out, want[0])
        assert _same(_without_disagreement(out), _without_disagreement(ref))
        assert records == want[1] and records
    (rec,) = eng.program_records()
    assert rec.captured and rec.replays == 2 * 4 - 1 and rec.in_place


@pytest.mark.gpu
@pytest.mark.parametrize("codec", [None, "int8"])
def test_meshed_train_federated_captured_equals_uncaptured(cuda, nccl_mesh,
                                                          codec):
    """``train_federated(mesh=)`` at NCCL world size 1 (sharded, one
    block, buffered telemetry, 3 rounds): the round program captured and
    replayed ``==`` ``uncaptured()`` and the run without ``mesh=``; the
    recorded collectives (the wire, two all-reduces a row, one loss
    broadcast a round) ``==``."""
    from repro_torch.launch import train
    cfg = _lm_cfg("dense")

    def run(mesh):
        tel = Telemetry()
        with scanloop.built_programs() as recs:
            p, h, _, st = train.train_federated(
                cfg, rounds=3, agents=4, tasks=2, local_steps=1, batch=1,
                seq=16, lr=1e-3, consensus_plan="sharded", codec=codec,
                mesh=mesh, telemetry=tel, device="cuda", return_state=True)
        return (p, h, st, tel.events(live_only=False)), recs

    (got, (rec,)), records = _recorded(lambda: run(nccl_mesh))
    with scanloop.uncaptured():
        (want, _), want_records = _recorded(lambda: run(nccl_mesh))
    ref, _ = run(None)
    assert _same(got, want)
    assert _same(_without_disagreement(got), _without_disagreement(ref))
    assert records == want_records
    assert [r.kind for r in records].count("broadcast_") == 3
    assert (rec.captures, rec.replays) == (1, 2) and rec.in_place
