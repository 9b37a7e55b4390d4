"""The port's benchmark harness (``repro_torch.launch.run``) against the JAX
package's ``benchmarks/run.py``, loaded by its path and run unchanged:
the paper sections' rows (names and ``derived`` strings ``==`` on the same
sweep JSON, and in the Table-II and partial fallbacks), the roofline rows
of a one-pair dry-run report, the kernel rows' shapes against the
reference's calls, the rows and CSV of a CPU run, and the launch check of
the ``cuda`` rows. The card-only test runs the kernel section on the card.

No test here imports JAX at module level: the reference is loaded inside
the tests that compare with it, so the ``gpu`` test runs where JAX is not
installed."""
import concurrent.futures
import contextlib
import functools
import importlib.util
import io
import json
import math
import multiprocessing as mp
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import InputShape  # noqa: E402
from repro_torch.launch import dryrun, roofline, run  # noqa: E402
from repro_torch.rl import fig4_tradeoff  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PAPER = ("bench_fig3", "bench_fig4", "bench_table2")
PLAIN_ROWS = [
    "kernel.flash_attention.plain.512", "kernel.flash_attention.swa.plain.512",
    "kernel.flash_attention.plain.128", "kernel.rglru_scan.plain.1024",
    "kernel.consensus_update.plain.1M", "kernel.quant_consensus.plain.1M",
    "kernel.rglru_scan_backward.plain.1024",
    "kernel.flash_attention_backward.plain.512"]
PROTOCOL_ROWS = ["protocol.maml_round.dqn", "protocol.maml_round.dqn.uncaptured",
                 "protocol.fl_round.dqn", "protocol.fl_round.dqn.uncaptured"]
MAIN_ROWS = [f"kernel.{op}.cuda.main" for op in (
    "quant_consensus", "consensus_update", "rglru_scan", "flash_attention",
    "rglru_scan_backward", "flash_attention_backward")]


@pytest.fixture
def reference(monkeypatch):
    """``benchmarks/run.py`` as a module, by its path, with the repository
    root on ``sys.path`` for its ``benchmarks.*`` imports."""
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "_ref_bench_run", ROOT / "benchmarks" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(mod, section):
    """(name, derived) of the rows ``section`` of ``mod`` prints."""
    mod.ROWS.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        getattr(mod, section)()
    return [(n, d) for n, _, d in mod.ROWS]


def _sweep_json(t0s):
    """A fig4 sweep's JSON over ``t0s``: Table II's rounds, perturbed."""
    rng = np.random.default_rng(0)
    mean = {str(t0): (np.asarray(fig4_tradeoff.PAPER_TABLE_II[t0])
                      * rng.uniform(0.5, 1.5, 6)).tolist() for t0 in t0s}
    out = {"mean_rounds": mean, "energies": {}}
    fig4_tradeoff._add_energies(out, [int(t) for t in t0s])
    return out


@pytest.mark.parametrize("t0s", [tuple(fig4_tradeoff.T0_GRID), None, (0,)],
                         ids=["measured", "paper-tableII", "partial-measured"])
def test_paper_sections_equal_reference(reference, monkeypatch, tmp_path,
                                        t0s):
    if t0s is not None:
        text = json.dumps(_sweep_json(t0s))
        for name in ("fig4.json", run.FIG4):     # the two harnesses' names
            (tmp_path / name).write_text(text)
    for mod in (reference, run):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
        monkeypatch.setattr(mod, "ROWS", [])
    for section in PAPER:
        if t0s == (0,) and section == "bench_table2":
            # with t0 = 0 alone there is no other t0 to scale down to:
            # both harnesses raise
            for mod in (reference, run):
                with pytest.raises(ValueError):
                    _rows(mod, section)
            continue
        got, want = _rows(run, section), _rows(reference, section)
        assert got == want and got, section
    tag = {None: "paper-tableII", (0,): "partial-measured"}.get(
        t0s, "measured")
    assert _rows(run, "bench_fig3")[0][0] == f"fig3.total_maml_kJ.{tag}"


@pytest.fixture(scope="module")
def one_pair_report():
    """A dry run's report of one (arch, shape) pair: reduced granite-8b
    training on a fake 2 x 2 group, in a spawned process."""
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=mp.get_context("spawn")) as ex:
        return ex.submit(dryrun.reduced_reports, [
            ("granite-8b", InputShape("train_4k", 32, 4, "train"),
             {})]).result()[0]


def test_roofline_rows(reference, monkeypatch, tmp_path, one_pair_report):
    for mod in (reference, run):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
        monkeypatch.setattr(mod, "ROWS", [])
    assert _rows(run, "bench_roofline") == [
        ("roofline.pairs", "pending(dryrun sweep)")]
    (tmp_path / "dryrun_single_pod.json").write_text(
        json.dumps({"reports": [one_pair_report], "failures": []}))
    a = roofline.analyze(one_pair_report)
    got = _rows(run, "bench_roofline")
    assert got == [
        ("roofline.granite-8b.train_4k.step_ms",
         f"{a['step_ms']:.2f}({a['bottleneck'][:4]})"),
        ("roofline.bottleneck_histogram", f"{a['bottleneck']}:1")]
    assert json.loads((tmp_path / "roofline.json").read_text()) == [
        json.loads(json.dumps(a))]
    # the reference reads the same roofline.json into the same rows
    assert _rows(reference, "bench_roofline") == got


def test_kernel_shapes_equal_reference(reference, monkeypatch):
    """The reference's kernel section, its wrappers replaced by recorders:
    each call's operand shapes and masks equal the twin's table."""
    from repro.kernels import ops as jops
    calls = []

    def recorder(name):
        def fn(*args, impl=None, block_q=None, block_k=None, **kw):
            calls.append((name, tuple(tuple(a.shape) for a in args), kw))
        return fn

    for name in ("flash_attention", "rglru_scan", "consensus_update"):
        monkeypatch.setattr(jops, name, recorder(name))
    monkeypatch.setattr(reference, "_time", lambda fn, *a, **k: fn(*a) or 1.0)
    monkeypatch.setattr(reference, "ROWS", [])
    with contextlib.redirect_stdout(io.StringIO()):
        reference.bench_kernels()
    twin = [(c.op, tuple(c.shapes.values()), c.kw)
            for c in run.KERNEL_CASES[:len(calls)]]
    assert calls == twin and len(calls) == 5
    assert [c.op for c in run.KERNEL_CASES[5:]] == [
        "quant_consensus", "rglru_scan_backward", "flash_attention_backward"]


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """``main(["--device", "cpu"])`` with the timed sections at reps 1 and
    warm-up 0: (rows, bench.csv's text)."""
    out = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(run, "RESULTS", str(out))
        mp_.setattr(run, "ROWS", [])
        for name in ("bench_kernels", "bench_protocol"):
            mp_.setattr(run, name, functools.partial(getattr(run, name),
                                                     reps=1, warmup=0))
        with contextlib.redirect_stdout(io.StringIO()):
            run.main(["--device", "cpu"])
        return list(run.ROWS), (out / "bench.csv").read_text()


def test_cpu_rows_are_the_plain_and_protocol_rows(cpu_run):
    rows, _ = cpu_run
    timed = [r for r in rows if r[0].startswith(("kernel.", "protocol."))]
    assert [n for n, _, _ in timed] == PLAIN_ROWS + PROTOCOL_ROWS
    assert all(math.isfinite(us) and us > 0 and d == "" for _, us, d in timed)
    assert [n for n, _, _ in rows[len(timed):]] == [
        "fig3.total_maml_kJ.paper-tableII",
        "fig3.total_fl_only_kJ.paper-tableII",
        "fig3.energy_reduction.paper-tableII",
        "fig4.optimal_t0.black_SL500_UL200", "fig4.optimal_t0.red_UL500_SL200",
        "table2.rounds_scaledown", "roofline.pairs"]


def test_main_writes_the_csv(cpu_run):
    rows, text = cpu_run
    assert text.splitlines() == ["name,us_per_call,derived"] + [
        f"{n},{u:.1f},{d}" for n, u, d in rows]


def test_cuda_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run.main(["--device", "cuda"])


def test_cuda_row_needs_one_launch_a_call():
    def launching():
        launching.launches += 1

    def silent():
        pass

    launching.launches = silent.launches = 0
    assert run._time_launches(launching, launching, reps=2, warmup=1) > 0
    assert launching.launches == 3
    with pytest.raises(RuntimeError, match="0 launches in 3 calls"):
        run._time_launches(silent, silent, reps=2, warmup=1)


@pytest.mark.parametrize("shapes", [
    dict(x=(1000,), nb=(2, 1000), sig=(2,)), dict(x=(8, 300))],
    ids=["agent", "population"])
def test_int8_lanes_equal_the_codec(shapes):
    """B1's operands, rounded in place in the harness, are the lanes and
    scales of the port's int8 codec (rounded to nearest) on the same rows:
    the own row and, for one agent, its two neighbours' rows."""
    from repro_torch.comms.codecs import get_codec
    quant = run.kernel_inputs(
        run.KernelCase("quant_consensus", "quant_consensus", "t", shapes),
        "cpu")[0]
    x, _, _, src = run.kernel_inputs(
        run.KernelCase("consensus_update", "consensus_update", "t", shapes),
        "cpu")[0]
    want = get_codec("int8").encode_leaf(
        x if src is None else torch.cat([x, src]))
    q, s = quant[1], quant[2]
    if src is not None:
        q, s = torch.cat([q, quant[6]]), torch.cat([s, quant[7]])
    assert torch.equal(quant[0], x)
    assert torch.equal(q, want["q"]) and torch.equal(s, want["scale"])


class _FakeCard:
    """``torch.cuda``'s events, hold and synchronize on a fake device clock
    (ms): a call of ``fn`` advances it by ``call_ms``, a read of the evict
    buffer by 0.5; the first ``short`` holds end before the host has
    queued its calls."""

    def __init__(self, monkeypatch, call_ms, short):
        self.now, self.call_ms, self.holds, self.short = 0.0, call_ms, [], short
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self):
                self.t = card.now

            def query(self):
                return len(card.holds) <= card.short

            def elapsed_time(self, end):
                return end.t - self.t

        class Evict:
            def sum(self):
                card.now += 0.5

        self.evict = Evict()
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep", self.holds.append)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def fn(self):
        self.now += self.call_ms


def test_device_ms_times_queued_calls_behind_a_hold(monkeypatch):
    from repro_torch.kernels import timing
    card = _FakeCard(monkeypatch, 1.5, short=1)
    # the evict reads are in both queues and drop out
    assert timing.device_ms(card.fn, n=4, evict=card.evict) == 1.5
    # the first hold ended before the calls were queued: both queues
    # again behind holds four times longer
    c = timing.HOLD_CYCLES
    assert card.holds == [c, c, 4 * c, 4 * c]
    card = _FakeCard(monkeypatch, 1.5, short=2 * timing.HOLDS)
    with pytest.raises(RuntimeError, match="longer to queue 10 calls"):
        timing.device_ms(card.fn)
    assert len(card.holds) == 2 * timing.HOLDS


@pytest.mark.gpu
def test_cuda_rows_on_the_card(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    monkeypatch.setattr(run, "RESULTS", str(tmp_path))
    monkeypatch.setattr(run, "ROWS", [])
    with contextlib.redirect_stdout(io.StringIO()):
        run.bench_kernels("cuda", reps=2, warmup=1)   # raises on a bad count
    names = [n for n, _, _ in run.ROWS]
    want = [n for p in PLAIN_ROWS for n in (p, p.replace(".plain.", ".cuda."))]
    assert names == want + MAIN_ROWS
    for name, us, derived in run.ROWS:
        assert math.isfinite(us) and us > 0, name
        if name.endswith(".main"):
            fields = dict(f.split("=") for f in derived.split(";"))
            assert float(fields["device_ms"]) > 0, name
            assert 0 < float(fields["share"]) <= 1.0, (name, derived)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
