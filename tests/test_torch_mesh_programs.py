"""The meshed engines' round programs on gloo groups of 2 and 4 ranks
(one spawn per world size, running all its cases:
``repro_torch.launch.multichip.run_program_checks``), against the same
runs in one process.

* ``train_federated(mesh=)`` — reduced granite-8b (one layer of width 32),
  the sharded plan two agents a rank and the distributed plan one, codecs
  None and int8 (error feedback), the sharded int8 run on fading links,
  the distributed int8 run with agents asleep:
  every rank's rows of the population and of the codec state, the loss
  history and the telemetry rows' exact fields ``==`` the one-process run
  (the sharded plan in as many blocks), the disagreement within its
  tolerance; C3 books the disagreement's all-reduces and the logged
  loss's broadcast exactly.
* The meshed FL driver: its round program is cached (the sampler and
  ``target_fn`` inside the round, ``host_fns == ()``), the second call
  hits and builds nothing, and both calls ``==`` the one-process run,
  one population gather an evaluated round.
* ``scan_rounds`` on a meshed engine holds one round program.

On the CPU the programs run eagerly (``why_uncaptured == "cpu"``), keyed
and counted as on the card; the captured side at NCCL world size 1 is in
``tests/test_torch_capture.py`` (``gpu``)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.analysis import costmodel as cm  # noqa: E402
from repro_torch.core import scanloop  # noqa: E402
from repro_torch.launch import mesh as mesh_lib, multichip  # noqa: E402

WORLDS = (2, 4)
CASES = range(len(multichip.train_cases(2)))

_RESULTS = {}


def _checks(world):
    """The world size's one spawn, run once per module."""
    if world not in _RESULTS:
        _RESULTS[world] = multichip.run_program_checks(world,
                                                       timeout_s=240.0)
    return _RESULTS[world]


def _rows(world, rank, tree):
    B = next(iter(tree.values())).shape[0]
    return slice(rank * B, (rank + 1) * B)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_train_federated_on_a_mesh_matches_one_process(world, case):
    (_, agents, _, codec, _, _), ranks, alone = _checks(world)["train"][case]
    assert len(ranks) == world
    n, max_abs = alone["scale"]
    held = set()
    for rank, got in enumerate(ranks):
        rows = _rows(world, rank, got["params"])
        held.update(range(rows.start, rows.stop))
        assert multichip.compare_rows(got["params"], alone["params"],
                                      rows) == (True, 0.0)
        assert multichip.compare_rows(got["state"], alone["state"],
                                      rows) == (True, 0.0)
        assert (got["state"] is None) == (codec is None)
        assert got["history"] == alone["history"]
        assert len(got["history"]) == multichip.TRAIN["rounds"]
        tel = multichip.compare_events(got["events"], alone["events"],
                                       agents, n, max_abs)
        assert tel["rows_equal"] and tel["n_rows"] == len(got["history"])
        assert tel["disagreement_of_tol"] <= 1.0
    assert held == set(range(agents))        # each agent on one rank


@pytest.mark.parametrize("world", WORLDS)
def test_train_federated_books_the_loss_broadcast(world):
    R = multichip.TRAIN["rounds"]
    for _, ranks, _ in _checks(world)["train"]:
        for got in ranks:
            ledger, c3 = multichip.fl_ledger(got, "train_federated")
            assert c3 == [] and ledger.unpriced_bytes == 0
            assert ledger.observer_calls == {
                "disagreement column sums": R, "disagreement distances": R,
                "logged loss of agent 0": R}
            assert ledger.observer_bytes["logged loss of agent 0"] == 4 * R
            assert [r.kind for r in got["records"]].count("broadcast_") == R
            assert ledger.wire_bytes > 0


@pytest.mark.parametrize("world", WORLDS)
def test_meshed_fl_driver_is_one_cached_program(world):
    out = _checks(world)
    ranks, alone, _ = out["fl"]
    for rank, (first, second) in enumerate(ranks):
        assert (first["misses"], first["hits"], first["builds"]) == (1, 0, 1)
        assert (second["misses"], second["hits"], second["builds"]) == (
            0, 1, 0)
        for run in (first, second):
            r = multichip.fl_compare(run, alone,
                                     _rows(world, rank, run["params"]),
                                     "sharded")
            assert r["ok"] and r["bit_equal"] and r["history_equal"], r
            assert r["gathers"] == r["gathers_expected"] > 0, r
    for programs in out["fl_programs"]:
        (rec,) = programs
        assert rec["cached"] and rec["family"] == "fl_chunk"
        assert rec["host_fns"] == () and not rec["streaming"]
        assert rec["group_backend"] == "gloo"
        assert rec["why_uncaptured"] == "cpu" and not rec["captured"]
        assert rec["eager_calls"] == 2 * multichip.FL["chunk"]


@pytest.mark.parametrize("world", WORLDS)
def test_meshed_scan_rounds_holds_one_program(world):
    out = _checks(world)
    for runs, programs in zip(out["scan"], out["scan_programs"]):
        a, b = runs
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k])
            np.testing.assert_array_equal(a["state"][k], b["state"][k])
        assert a["events"] == b["events"]
        (rec,) = programs
        assert rec["cached"] and rec["family"] == "scan_rounds"
        assert rec["group_backend"] == "gloo" and rec["donate_argnums"] == (
            0,)
        assert rec["eager_calls"] == 2 * multichip.PARITY_ROUNDS


def test_recorder_takes_a_replays_collectives(tmp_path):
    """What a replay hands a ``CollectiveRecorder`` (the capture's ops,
    their tensors as ``meta`` tensors) records as the live ops do, and
    ``scanloop.agree`` reduces over the group outside the recorder."""
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"))
    try:
        group = torch.distributed.group.WORLD
        seen = scanloop._LastOp()
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        out = torch.empty((2, 3))
        with cm.CollectiveRecorder() as live:
            with seen.mode:
                torch.distributed.all_reduce(x, group=group)
                torch.distributed.all_gather_into_tensor(out, x,
                                                         group=group)
                torch.distributed.broadcast(x, src=0, group=group)
            assert scanloop.agree(group, [3, True], "max") == [3, 1]
        assert [r.kind for r in live.records] == [
            "allreduce_", "_allgather_base_", "broadcast_"]
        with cm.CollectiveRecorder() as replay:
            scanloop._hand_to_recorders(seen.collectives)
        assert replay.records == live.records
        assert all(a.device.type == "meta" for _, args in seen.collectives
                   for a in args if isinstance(a, torch.Tensor))
    finally:
        mesh_lib.destroy_local_group()


def test_meshed_program_on_the_cpu_says_why(tmp_path):
    """A program given a gloo group runs eagerly on CPU tensors, naming
    the device, and records the group's backend."""
    mesh_lib.init_local_group(0, 1, str(tmp_path / "store"))
    try:
        group = torch.distributed.group.WORLD

        def body(c):
            s = c * 2
            torch.distributed.all_reduce(s, group=group)
            return (s,), s.sum()

        prog = scanloop.donating_graph(body, donate_argnums=(0,),
                                       name="meshed_cpu", group=group)
        (c,), total = prog(torch.ones(4))
        assert torch.equal(c, torch.full((4,), 2.0)) and float(total) == 8
        rec = prog.record
        assert (rec.group_backend, rec.why_uncaptured, rec.eager_calls) == (
            "gloo", "cpu", 1)
    finally:
        mesh_lib.destroy_local_group()
