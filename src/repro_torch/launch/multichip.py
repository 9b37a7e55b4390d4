"""Mesh checks of the consensus engine's sharded and distributed plans.

Three checks, on MASKED rounds (links fading with p = 0.3, the round the
per-edge survival convention draws; a static round would miss what
masking changes) unless a case names another process:

* **mesh vs emulation** — each plan driven on a real process group (each
  process holding its own rows: a block on ``sharded``, one agent on
  ``distributed``) for :data:`PARITY_ROUNDS` rounds of ``scan_rounds``
  with a generator (stochastic rounding on the int wire) and buffered
  telemetry must agree with the same engine built without a mesh, which
  runs the whole population in one process through the same per-block
  and per-slot functions: params, codec state, the generator's final
  state, every row's exact fields ``==`` and its disagreement within
  :func:`repro_torch.telemetry.buffer.disagreement_tolerance`, and on
  async engines the :class:`AsyncState` of as many ``async_step`` rounds.
  The sharded plan must agree bit for bit; the distributed plan sums the
  same slots in the same order, and is held to the sparse-vs-dense gate
  (1e-5 plus 4 f32 ulps of the largest value) all the same. :func:`run_parity` spawns a gloo group
  of any size on the CPU; on one card the group is NCCL at world size 1
  (NCCL takes one card per process, and gloo carries no CUDA all_gather
  or send/recv).
* **the FL drivers on a mesh** — :func:`run_mesh_checks`:
  ``run_fl_until_scan`` (chunk 8) and ``run_fl_until`` on a regression
  pull toward seeded targets, the hit mid-chunk, each rank on its own
  rows, against the same run without a mesh: every rank's params, codec
  state, t_i, history, the generator's final state and rows as above;
  each rank's collectives recorded, one population gather per evaluated
  round (none on the rounds an ``eval_every`` of 2 skips) and C3 clean.
* **no (K, K) buffer** (the counterpart of the JAX package's HLO rule H1,
  read from device memory): one masked sharded round at K = 16384, N =
  2048 may add at most 4× the population's f32 bytes to the card's peak
  allocation (512 MiB; one (K, K) f32 buffer is 1 GiB).

The collective ledger (the bytes each rank's round ships against the
codec's Eq.-(11) bits) is :mod:`repro_torch.analysis.costmodel`'s C1a and
C3. :func:`dry_run_sharded` and :func:`dry_run_distributed` are the JAX
harness's compile-and-inspect checks on a fake process group (rank 0 of
8 or K ranks, nothing moved): no (K, K) buffer among the shapes a masked
round produces, the wire collective present, an int8 wire carrying int8,
the C3 ledger clean. Its donation check (JX3) is not made there: the dry
run steps the engine once, outside any program; the round programs'
JX3, meshed or not, is ``python -m repro_torch.analysis --layer
programs``.

* **the meshed round programs** — :func:`run_program_checks`:
  ``train_federated(mesh=)`` (:func:`train_cases`) against the same run
  in one process, the meshed FL driver's cached program hit on a second
  call, and ``scan_rounds``' program held by its engine.

For the LM zoo, :func:`run_lm_parity` spawns a data x model gloo group
and runs :func:`lm_mesh_case` on each rank: the tensor- and data-parallel
transformer's logits, loss, gradient and one Adam step, which the tests
hold to the one-process port (tests/test_torch_sharding.py).

Run (an NCCL group, one card per process, the parity and FL rows, then
the memory bound on card 0; it refuses by name on a host with fewer cards
than ``--world``)::

    PYTHONPATH=src python -m repro_torch.launch.multichip [--world 4]
        [--backend nccl|gloo] [--out build/results/torch_multichip.json]

``--backend gloo`` runs the group on the CPU, and then H1, which reads
the card's memory, does not run: the report and stdout say so.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import ConsensusEngine
from repro_torch.launch import mesh as mesh_lib

DROPOUT_P, DROPOUT_SEED, ROUND_T = 0.3, 0, 3
H1_K, H1_N = 16384, 2048
#: rounds of ``scan_rounds`` in each parity case (the JAX package's 4)
PARITY_ROUNDS = 4
#: the generator behind every parity and FL run's stochastic rounding
GEN_SEED = 1
#: the FL case: params width, SGD rate, rounds, chunk, and the seed of
#: the params (the targets' is the next one)
FL = dict(n=24, lr=0.3, max_rounds=16, chunk=8, seed=5)
#: each FL case runs ``run_fl_until_scan`` at the chunk and ``run_fl_until``
FL_CHUNKS = (FL["chunk"], 1)
#: telemetry fields that read only the round's draws: ``==`` on every
#: rank, against the one-process rows and the JAX package's
EXACT = ("round", "n_sl", "n_ul", "n_dl", "edges", "n_active", "max_age",
         "agent_sl", "agent_ul", "agent_dl", "wire_bits", "joules",
         "agent_joules")


def tolerance(x: np.ndarray) -> float:
    """The sparse-vs-dense gate: 1e-5 plus 4 f32 ulps of the largest
    value."""
    return 1e-5 + 4 * float(np.finfo(np.float32).eps) * float(
        np.abs(x).max())


def population(K: int, n: int, seed: int = 0) -> dict:
    """Two leaves of standard-normal f32 params over K agents (numpy)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, n)).astype(np.float32),
            "b": rng.standard_normal((K, 7)).astype(np.float32)}


def agent_mesh(n: int = 8, device_type=None):
    """1-D mesh of ``n`` positions (axis ``"agents"``) over the initialised
    process group, which must have ``n`` ranks: the JAX package's
    ``agent_mesh`` (there ``n`` of the forced host devices), here
    :func:`repro_torch.launch.mesh.make_agent_mesh`."""
    return mesh_lib.make_agent_mesh(n, device_type=device_type)


def process_kw(process: str) -> dict:
    """Engine keywords of a graph/agent process: ``static``, ``fading``
    (links fade with p = 0.3) or ``async`` (agents awake with p = 0.7,
    τ = 2, λ = 0.9)."""
    if process == "fading":
        return dict(graph=topo_lib.GraphProcess.dropout(DROPOUT_P,
                                                        DROPOUT_SEED))
    if process == "async":
        return dict(agents=topo_lib.AgentProcess.bernoulli(0.7, seed=2),
                    tau=2, staleness_decay=0.9)
    if process != "static":
        raise ValueError(f"unknown process {process!r}: choose static, "
                         "fading or async")
    return {}


def masked_engine(topo, plan, codec, *, mesh=None, num_blocks=None,
                  process="fading"):
    return ConsensusEngine(topo, codec=codec, plan=plan, mesh=mesh,
                           num_blocks=num_blocks, **process_kw(process))


def mesh_pair(topo, plan, codec, mesh, process="fading"):
    """(the engine on ``mesh``, the same engine without it): the sharded
    plan in as many blocks as the mesh has positions."""
    positions = int(mesh.size(0))
    nb = positions if plan == "sharded" else None
    on_mesh = masked_engine(topo, plan, codec, mesh=mesh, num_blocks=nb,
                            process=process)
    if on_mesh.local_rows is None:
        raise ValueError(
            f"{plan} on a {positions}-position mesh does not run on the "
            f"mesh for K={topo.K}: use K = {positions} (distributed) or a "
            "multiple of it (sharded)")
    return on_mesh, masked_engine(topo, plan, codec, num_blocks=nb,
                                  process=process)


def compare_rows(got, want, rows) -> tuple:
    """(bit_equal, max |d|) of this rank's ``got`` against ``rows`` of the
    one-process ``want`` (dicts of tensors or arrays, or both None)."""
    if got is None or want is None:
        return got is None and want is None, 0.0
    equal, err = True, 0.0
    for k in want:
        a = np.asarray(got[k])
        b = np.asarray(want[k])[rows]
        if a.shape == b.shape and np.array_equal(a, b):
            continue
        equal = False
        err = max(err, float(np.abs(a.astype(np.float64) - b).max())
                  if a.shape == b.shape else float("inf"))
    return equal, err


def compare_events(got, want, K, n, max_abs) -> dict:
    """This rank's telemetry events against the one-process ones: the
    :data:`EXACT` fields ``==``, the live flags and metrics ``==`` and the
    disagreement within its tolerance."""
    from repro_torch.telemetry.buffer import disagreement_tolerance

    same = len(got) == len(want) and all(
        all(g[f] == w[f] for f in EXACT + ("live", "reached", "metric"))
        for g, w in zip(got, want))
    err = worst = 0.0
    for g, w in zip(got, want):
        d = abs(g["disagreement"] - w["disagreement"])
        err = max(err, d)
        worst = max(worst, d / disagreement_tolerance(
            K, n, max_abs, w["disagreement"]))
    return dict(rows_equal=same, n_rows=len(got), disagreement_err=err,
                disagreement_of_tol=worst)


def _numpy(tree):
    return None if tree is None else {k: v.detach().cpu().numpy()
                                      for k, v in tree.items()}


def scan_run(eng, x, device) -> dict:
    """:data:`PARITY_ROUNDS` rounds of ``scan_rounds`` from ``ROUND_T``
    with a generator and buffered telemetry, and on an async engine as
    many ``async_step`` rounds from a fresh :class:`AsyncState`."""
    from repro_torch.telemetry import Telemetry

    gen = torch.Generator(device=device).manual_seed(GEN_SEED)
    tel = Telemetry()
    p, st = eng.scan_rounds(x, None, gen, rounds=PARITY_ROUNDS, t0=ROUND_T,
                            telemetry=tel)
    ast = None
    if eng.agents is not None:
        ast, q, qs = eng.init_async_state(device=device), x, None
        for i in range(PARITY_ROUNDS):
            q, qs, ast, _ = eng.async_step(q, qs, gen, t=ROUND_T + i,
                                           state=ast)
        ast = {"clock": ast.clock.cpu().numpy(), "age": ast.age.cpu().numpy()}
    return dict(params=_numpy(p), state=_numpy(st), events=tel.events(),
                gen=gen.get_state().numpy(), async_state=ast)


def parity_case(topo, plan, codec, mesh, device, process="fading") -> dict:
    """:data:`PARITY_ROUNDS` rounds of ``plan`` on ``mesh`` against the
    same engine without a mesh (:func:`scan_run`), on this process's
    rows."""
    on_mesh, alone = mesh_pair(topo, plan, codec, mesh, process)
    rows = on_mesh.local_rows
    pop = population(topo.K, 64)
    full = {k: torch.from_numpy(v).to(device) for k, v in pop.items()}
    mine = {k: v[rows].contiguous() for k, v in full.items()}
    got, want = scan_run(on_mesh, mine, device), scan_run(alone, full,
                                                          device)
    tol = max(tolerance(v) for v in pop.values())
    p_eq, p_err = compare_rows(got["params"], want["params"], rows)
    s_eq, s_err = compare_rows(got["state"], want["state"], rows)
    equal, err = p_eq and s_eq, max(p_err, s_err)
    n = sum(v.shape[1] for v in pop.values())
    tel = compare_events(got["events"], want["events"], topo.K, n,
                         max(float(np.abs(v).max()) for v in pop.values()))
    gen_eq = bool(np.array_equal(got["gen"], want["gen"]))
    ast_eq = (got["async_state"] is None and want["async_state"] is None) \
        or all(np.array_equal(got["async_state"][k],
                              want["async_state"][k])
               for k in ("clock", "age"))
    return dict(plan=plan, codec=codec, process=process, K=topo.K,
                positions=int(mesh.size(0)), rows=[rows.start, rows.stop],
                rounds=PARITY_ROUNDS, bit_equal=equal, max_abs_err=err,
                tolerance=tol, generator_equal=gen_eq, async_equal=ast_eq,
                **tel,
                ok=(equal if plan == "sharded" else err <= tol)
                and tel["rows_equal"] and tel["disagreement_of_tol"] <= 1.0
                and gen_eq and ast_eq)


def case_graph(K: int):
    """The cases' graph of K agents: small_world(k=4) from K = 8, a ring
    below, one agent with no edge at K = 1."""
    if K == 1:
        return topo_lib.full(1)
    return (topo_lib.small_world(K, k=4, seed=1) if K >= 8
            else topo_lib.ring(K))


def parity_cases(world: int):
    """(topology, plan, codec) cases a ``world``-position mesh runs: the
    sharded plan over 4 agents per position, the distributed plan over
    one agent per position, each with no codec and the int8 wire."""
    return [(case_graph(K), plan, codec) for codec in (None, "int8")
            for K, plan in ((4 * world, "sharded"), (world, "distributed"))]


def run_parity(world: int, cases=None, *, backend: str = "gloo",
               timeout_s: float = 120.0) -> list:
    """Spawn ``world`` processes on this host (a gloo group through a
    file store) and run :func:`parity_case` for each case (topology, plan,
    codec[, process]; default :func:`parity_cases`) in each of them: the
    parity half of :func:`run_mesh_checks`. Returns every rank's rows;
    raises if a rank failed, hung or disagreed with its emulation."""
    return run_mesh_checks(world, cases, [], backend=backend,
                           timeout_s=timeout_s)["parity"]


def fl_targets(x, device) -> dict:
    """The FL case's seeded targets, one per leaf of ``x`` in one agent's
    shape (every agent pulls toward the same), drawn on the host from
    ``FL["seed"] + 1`` in leaf order."""
    rng = np.random.default_rng(FL["seed"] + 1)
    return {k: torch.from_numpy(rng.standard_normal(
                tuple(v.shape[1:])).astype(np.float32)).to(device)
            for k, v in x.items()}


def rounds_computed(t_i: int, chunk: int, max_rounds: int) -> int:
    """Rounds a driver at ``chunk`` computed when it stopped after ``t_i``
    rounds (``max_rounds`` without a hit): the hit's chunk runs to its
    end."""
    return min(-(-t_i // chunk) * chunk, max_rounds)


def _scale(trees) -> tuple:
    """(params per agent, largest magnitude) over the stacked ``trees[0]``
    and every tree after it."""
    n = sum(int(np.prod(v.shape[1:])) for v in trees[0].values())
    return n, max(float(abs(v).max()) for t in trees for v in t.values())


def fl_functions(K, x, thr, device) -> tuple:
    """``(sample, loss, target_fn)`` of the FL case (:func:`fl_run`) for K
    agents shaped like ``x``'s rows and the threshold ``thr``: made once
    and passed to several runs, they key one cached round program."""
    target = fl_targets(x, device)

    def sample(gen, _t):
        return {k: v + 0.1 * torch.randn((K, 1) + tuple(v.shape),
                                         generator=gen, device=device)
                for k, v in target.items()}

    def loss(p, b):
        return sum(0.5 * (p[k] - b[k]).square().sum() for k in p)

    def target_fn(stacked):
        m = sum((stacked[k] - target[k]).square().mean() for k in stacked)
        return m < thr, m

    return sample, loss, target_fn


def fl_run(eng, x, thr, *, chunk, device, max_rounds=FL["max_rounds"],
           eval_every=1, record=False, fns=None) -> dict:
    """One FL run of the case: K agents, one local step a round on
    ½‖w − w*‖² toward :func:`fl_targets` plus noise
    the sampler draws from the run's generator (which also drives the int
    wire's stochastic rounding), ``target_fn`` the mean squared distance
    of the population below ``thr`` on the ``eval_every`` grid;
    ``run_fl_until_scan`` at ``chunk`` (``run_fl_until`` at chunk 1),
    buffered telemetry into an in-memory sink (``emitted``: the events it
    heard), ``max_rounds`` at most. ``x`` is
    this process's rows (on a mesh) or the population.
    ``wall``: seconds of the driver call, the device synchronised on
    either side; ``scale``: :func:`_scale` of ``x``, the targets and the
    result. With ``record``, also the c10d ops the driver dispatched
    (``records``), ``eng.audit_meta()`` and the observer calls the run
    must make (``observer_calls``), for :func:`fl_ledger`. ``fns``: the
    run's :func:`fl_functions` (default: made for this run, so its round
    program is built anew)."""
    from repro_torch.analysis import costmodel
    from repro_torch.core import federated
    from repro_torch.telemetry import MemorySink, Telemetry

    target = fl_targets(x, device)
    sample, loss, target_fn = (fl_functions(eng.K, x, thr, device)
                               if fns is None else fns)

    gen = torch.Generator(device=device).manual_seed(GEN_SEED)
    sink = MemorySink()
    tel = Telemetry(sinks=(sink,))
    kw = dict(target_fn=target_fn, max_rounds=max_rounds, generator=gen,
              eval_every=eval_every, return_state=True, telemetry=tel)
    if chunk != 1:
        kw["chunk"] = chunk
    driver = (federated.run_fl_until if chunk == 1
              else federated.run_fl_until_scan)
    rec = (costmodel.CollectiveRecorder() if record
           else contextlib.nullcontext())
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rec:
        p, t_i, hist, st = driver(loss, x, sample, eng, FL["lr"], **kw)
    if cuda:
        torch.cuda.synchronize()
    out = dict(wall=time.perf_counter() - t0, params=_numpy(p),
               state=_numpy(st), rounds=t_i, history=hist,
               events=tel.events(),
               emitted=len(sink.events), gen=gen.get_state().numpy(),
               scale=_scale([x, target, p]))
    if record:
        computed = rounds_computed(t_i, chunk, max_rounds)
        out.update(records=list(rec.records),
                   meta=eng.audit_meta({k: v[0] for k, v in x.items()}),
                   observer_calls=costmodel.observer_calls(
                       computed // eval_every, computed))
    return out


def fl_ledger(run, label: str):
    """C3's ledger and findings of a recorded :func:`fl_run`: the plan's
    wire priced, exactly the observer calls the run must make booked on
    their own line, anything else control plane or a finding."""
    from repro_torch.analysis.costmodel import collective_ledger
    return collective_ledger(run["meta"], run["records"], label,
                             run["observer_calls"])


def fl_threshold(eng, x, *, device) -> float:
    """A threshold the run of ``eng`` from ``x`` first meets in round 3
    (t_i = 4, mid-chunk at chunk 8), halfway between that round's metric
    and the smallest before it, from a 4-round probe that never stops
    (the chunk changes no bit, so its rounds are the run's)."""
    h = fl_run(eng, x, -1.0, chunk=4, device=device,
               max_rounds=4)["history"]
    if not h[3] < min(h[:3]):
        raise RuntimeError(f"FL probe {eng.plan.kind}: round 3's metric is "
                           f"not the first new low ({h})")
    return (h[3] + min(h[:3])) / 2


def fl_case(case) -> tuple:
    """(topology, plan, codec, process, eval_every) of an FL case given
    with or without its ``eval_every`` (default 1)."""
    return tuple(case[:4]) + ((case[4],) if len(case) > 4 else (1,))


def fl_cases(world: int) -> list:
    """The FL cases of a ``world``-rank group: (topology, plan, codec,
    process, eval_every) for the sharded plan over 4 agents a rank on
    fading links and the distributed plan over one agent a rank with
    agents asleep (:func:`case_graph`), codecs None and int8, every round
    evaluated; and the sharded int8 case evaluated every 2nd round."""
    return [(case_graph(K), plan, codec, proc, 1)
            for plan, K, proc in (("sharded", 4 * world, "fading"),
                                  ("distributed", world, "async"))
            for codec in (None, "int8")] + [
        (case_graph(4 * world), "sharded", "int8", "fading", 2)]


def check_rows(rank, world, parity, fl, device="cpu"):
    """One rank of :func:`run_mesh_checks` on the initialised group: each
    parity case's row (:func:`parity_case`) and each FL case's meshed runs
    at each of :data:`FL_CHUNKS` on this rank's rows, recorded (an FL case
    is (topology, plan, codec, process, eval_every, threshold))."""
    mesh = agent_mesh(world, device_type=device)
    rows = [parity_case(*c[:3], mesh, device, *c[3:]) for c in parity]
    runs = []
    for topo, plan, codec, process, every, thr in fl:
        eng, _ = mesh_pair(topo, plan, codec, mesh, process)
        full = population(topo.K, FL["n"], FL["seed"])
        mine = {k: torch.from_numpy(v[eng.local_rows]).to(device)
                for k, v in full.items()}
        runs.append({c: fl_run(eng, mine, thr, chunk=c, device=device,
                               eval_every=every, record=True)
                     for c in FL_CHUNKS})
    return rows, runs


def fl_compare(got, want, rows, plan: str) -> dict:
    """A rank's FL run against the one-process run of the same case: the
    sharded plan ``==``, the distributed plan within :func:`tolerance` of
    the one-process run's largest magnitude; t_i, history, the generator
    and the rows' exact fields ``==``; for a recorded run, the population
    gathers it issued (``gathers``, c10d ``allgather_``) against the
    rounds it evaluated and C3 over its collectives (:func:`fl_ledger`)."""
    n, max_abs = want["scale"]
    K = next(iter(want["params"].values())).shape[0]
    tol = tolerance(np.asarray(max_abs))
    p_eq, p_err = compare_rows(got["params"], want["params"], rows)
    s_eq, s_err = compare_rows(got["state"], want["state"], rows)
    tel = compare_events(got["events"], want["events"], K, n, max_abs)
    same_run = (got["rounds"], got["history"]) == (want["rounds"],
                                                   want["history"])
    gen_eq = bool(np.array_equal(got["gen"], want["gen"]))
    equal = p_eq and s_eq
    audit = {}
    if "records" in got:
        _, c3 = fl_ledger(got, f"fl:{plan}")
        audit = dict(
            gathers=sum(r.kind == "allgather_" for r in got["records"]),
            gathers_expected=got["observer_calls"][
                "population for target_fn"],
            c3=[f.message for f in c3])
    return dict(rounds=got["rounds"], history_equal=same_run,
                emitted=got["emitted"], bit_equal=equal,
                max_abs_err=max(p_err, s_err),
                tolerance=tol, generator_equal=gen_eq, **tel, **audit,
                ok=same_run and gen_eq and tel["rows_equal"]
                and tel["disagreement_of_tol"] <= 1.0
                and not audit.get("c3")
                and audit.get("gathers") == audit.get("gathers_expected")
                and (equal if plan == "sharded"
                     else max(p_err, s_err) <= tol))


def run_mesh_checks(world: int, parity=None, fl=None, *,
                    backend: str = "gloo", timeout_s: float = 180.0) -> dict:
    """The ``parity`` cases (default :func:`parity_cases`) and the ``fl``
    cases (default :func:`fl_cases`) on ONE spawned ``world``-rank group. For
    the FL cases this process first picks each case's threshold from a
    probe (:func:`fl_threshold`) and runs the case without a mesh at each
    of :data:`FL_CHUNKS`; the ranks run it on their rows, and each rank's
    run is held to it (:func:`fl_compare`). Returns ``{"parity": rows,
    "fl": rows, "cases": the FL cases (:func:`fl_case`) with thresholds,
    "alone": {case index: {chunk: run}}}``; raises if a rank disagreed."""
    parity = parity_cases(world) if parity is None else parity
    fl = fl_cases(world) if fl is None else fl
    device = "cuda" if backend == "nccl" else "cpu"
    full_cases, alone = [], {}
    for i, case in enumerate(fl):
        topo, plan, codec, process, every = fl_case(case)
        nb = world if plan == "sharded" else None
        x = {k: torch.from_numpy(v).to(device)
             for k, v in population(topo.K, FL["n"], FL["seed"]).items()}
        thr = fl_threshold(masked_engine(topo, plan, codec, num_blocks=nb,
                                         process=process), x, device=device)
        full_cases.append((topo, plan, codec, process, every, thr))
        eng = masked_engine(topo, plan, codec, num_blocks=nb,
                            process=process)
        alone[i] = {c: fl_run(eng, x, thr, chunk=c, device=device,
                              eval_every=every)
                    for c in FL_CHUNKS}
    got = mesh_lib.run_on_group(world, check_rows, parity, full_cases,
                                device, backend=backend, timeout_s=timeout_s)
    parity_rows_ = [dict(rank=r, **row) for r, (rows, _) in enumerate(got)
                    for row in rows]
    fl_rows_ = []
    for rank, (_, runs) in enumerate(got):
        for i, case in enumerate(full_cases):
            topo, plan, codec, process, every, thr = case
            B = topo.K // world
            local = slice(rank * B, (rank + 1) * B)
            for c in FL_CHUNKS:
                fl_rows_.append(dict(
                    rank=rank, plan=plan, codec=codec, process=process,
                    eval_every=every, K=topo.K, chunk=c, threshold=thr,
                    **fl_compare(runs[i][c], alone[i][c], local, plan)))
    wrong = [r for r in parity_rows_ + fl_rows_ if not r["ok"]]
    if wrong:
        raise RuntimeError(f"mesh path disagrees with the one-process "
                           f"run: {wrong}")
    return {"parity": parity_rows_, "fl": fl_rows_, "cases": full_cases,
            "alone": alone}


#: ``train_federated`` on a mesh (:func:`train_run`): granite-8b reduced
#: to one layer of width 32, and the run's arguments
TRAIN = dict(rounds=2, local_steps=1, batch=1, seq=8, lr=1e-2)


def train_cfg():
    """The reduced granite-8b :func:`train_run` trains."""
    from repro_torch.configs import get_arch, reduced
    return reduced(get_arch("granite-8b"), num_layers=1, d_model=32)


def train_cases(world: int) -> list:
    """(plan, agents, tasks, codec, dropout_p, awake_p) of
    ``train_federated`` on a ``world``-rank group: the sharded plan two
    agents a rank, the distributed plan one, in clusters that span ranks
    (one cluster at 2 ranks, two at 4); codecs None and int8 (error
    feedback); the sharded int8 run on links fading with p = 0.3, the
    distributed int8 run with agents awake with p = 0.7 (τ = 2)."""
    tasks = max(1, world // 2)
    return [("sharded", 2 * world, tasks, None, 0.0, None),
            ("sharded", 2 * world, tasks, "int8", DROPOUT_P, None),
            ("distributed", world, tasks, None, 0.0, None),
            ("distributed", world, tasks, "int8", 0.0, 0.7)]


def train_run(case, world: int, *, mesh=None, device="cpu",
              record=False) -> dict:
    """One ``train_federated`` run of ``case`` (:func:`train_cases`) with
    buffered telemetry: on ``mesh`` (the run returns this rank's rows), or
    in one process with the sharded plan in ``world`` blocks, as the
    meshed run splits it. With ``record``, the c10d ops it dispatched,
    the engine's ``audit_meta()`` and the observer calls the run must
    make (two all-reduces a row, one loss broadcast a round)."""
    from repro_torch.analysis import costmodel
    from repro_torch.core import topology
    from repro_torch.launch import train
    from repro_torch.telemetry import Telemetry

    plan, agents, tasks, codec, p, awake = case
    asleep = ({} if awake is None else dict(
        availability=topology.AgentProcess.bernoulli(awake, seed=1), tau=2))
    cfg = train_cfg()
    tel = Telemetry()
    rec = (costmodel.CollectiveRecorder() if record
           else contextlib.nullcontext())
    with rec, contextlib.redirect_stdout(io.StringIO()):
        params, hist, _, st = train.train_federated(
            cfg, agents=agents, tasks=tasks, consensus_plan=plan,
            codec=codec, dropout_p=p, mesh=mesh, telemetry=tel,
            num_blocks=world if plan == "sharded" else None, device=device,
            return_state=True, **asleep, **TRAIN)
    out = dict(params=_numpy(params), state=_numpy(st), history=hist,
               events=tel.events(), scale=_scale([params]))
    if record:
        graph = (topology.GraphProcess.dropout(p, seed=0) if p > 0
                 else None)
        eng = ConsensusEngine(topology.clusters(tasks, agents // tasks),
                              codec=codec, mesh=mesh, plan=plan, graph=graph,
                              agents=asleep.get("availability"),
                              tau=asleep.get("tau"))
        rounds = TRAIN["rounds"]
        out.update(records=list(rec.records),
                   meta=eng.audit_meta({k: v[0] for k, v in params.items()}),
                   observer_calls=costmodel.observer_calls(0, rounds,
                                                           losses=rounds))
    return out


def program_rows(rank, world, cases, fl, device="cpu") -> dict:
    """One rank of :func:`run_program_checks` on the initialised group:
    each ``train_federated`` case (:func:`train_run`, recorded); the FL
    case ``fl`` (topology, plan, codec, process, eval_every, threshold)
    driven twice with one set of :func:`fl_functions`, each call's
    program-cache hits, misses and builds, the cached program's record;
    and :data:`PARITY_ROUNDS` rounds of ``scan_rounds`` twice on the
    sharded engine of :func:`parity_case`, with the records its engine
    holds."""
    from repro_torch.core import scanloop

    mesh = agent_mesh(world, device_type=device)
    out = dict(train=[train_run(c, world, mesh=mesh, device=device,
                                record=True) for c in cases])
    topo, plan, codec, process, every, thr = fl
    eng, _ = mesh_pair(topo, plan, codec, mesh, process)
    full = population(topo.K, FL["n"], FL["seed"])
    mine = {k: torch.from_numpy(v[eng.local_rows]).to(device)
            for k, v in full.items()}
    fns = fl_functions(eng.K, mine, thr, device)
    runs = []
    for _ in range(2):
        before = scanloop.cache_stats()
        run = fl_run(eng, mine, thr, chunk=FL["chunk"], device=device,
                     eval_every=every, record=True, fns=fns)
        after = scanloop.cache_stats()
        run.update({k: after[k] - before[k] for k in ("hits", "misses")},
                   builds=after["trace_counts"].get("fl_chunk", 0)
                   - before["trace_counts"].get("fl_chunk", 0))
        runs.append(run)
    out["fl"] = runs
    out["fl_programs"] = [_record_fields(r)
                          for r in scanloop.registered_programs()
                          if r.cache_key is not None
                          and r.cache_key[0] == "fl_chunk"
                          and r.cache_key[4] is eng]
    stopo = case_graph(4 * world)
    on_mesh, _ = mesh_pair(stopo, "sharded", "int8", mesh)
    x = {k: torch.from_numpy(v[on_mesh.local_rows]).to(device)
         for k, v in population(stopo.K, 64).items()}
    out["scan"] = [scan_run(on_mesh, x, device) for _ in range(2)]
    out["scan_programs"] = [_record_fields(r)
                            for r in on_mesh.program_records()]
    return out


def _record_fields(rec) -> dict:
    """The picklable fields of a ``scanloop.ProgramRecord``."""
    return dict(name=rec.name, cached=rec.cache_key is not None,
                family=None if rec.cache_key is None else rec.cache_key[0],
                host_fns=rec.host_fns, streaming=rec.streaming,
                captured=rec.captured, why_uncaptured=rec.why_uncaptured,
                group_backend=rec.group_backend, eager_calls=rec.eager_calls,
                captures=rec.captures, replays=rec.replays,
                async_argnums=rec.async_argnums,
                donate_argnums=rec.donate_argnums)


def run_program_checks(world: int, *, timeout_s: float = 180.0) -> dict:
    """The meshed round programs on ONE spawned gloo group of ``world``
    ranks (:func:`program_rows`), beside the same runs in this process
    without a mesh: ``{"train": [(case, [rank rows], one-process run)],
    "fl": ([rank rows], {chunk: one-process run}, case), "scan": [rank
    rows], "world": world}``."""
    cases = train_cases(world)
    alone = [train_run(c, world) for c in cases]
    topo = case_graph(4 * world)
    x = {k: torch.from_numpy(v)
         for k, v in population(topo.K, FL["n"], FL["seed"]).items()}
    thr = fl_threshold(masked_engine(topo, "sharded", "int8",
                                     num_blocks=world), x, device="cpu")
    fl = (topo, "sharded", "int8", "fading", 1, thr)
    fl_alone = fl_run(masked_engine(topo, "sharded", "int8",
                                    num_blocks=world), x, thr,
                      chunk=FL["chunk"], device="cpu")
    got = mesh_lib.run_on_group(world, program_rows, cases, fl, "cpu",
                                timeout_s=timeout_s)
    return dict(world=world,
                train=[(c, [g["train"][i] for g in got], alone[i])
                       for i, c in enumerate(cases)],
                fl=([g["fl"] for g in got], fl_alone, fl),
                fl_programs=[g["fl_programs"] for g in got],
                scan=[g["scan"] for g in got],
                scan_programs=[g["scan_programs"] for g in got])


def _masked_round_records(topo, plan, codec, world, n, **kw):
    """One masked round of ``plan`` at rank 0 of a ``FakeStore`` group of
    ``world`` ranks (collectives move nothing, so values are not
    checked): (the engine, its recorder). The params are CPU tensors of
    this rank's rows."""
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.hlo_analysis import StepRecorder

    fake_group(world)
    try:
        mesh = agent_mesh(world, device_type="cpu")
        eng = masked_engine(topo, plan, codec, mesh=mesh, **kw)
        rows = eng.local_rows
        params = {"w": torch.zeros((rows.stop - rows.start, n),
                                   dtype=torch.float32)}
        state = eng.init_state(params)
        rec = StepRecorder()
        t0 = time.perf_counter()
        with rec.recording():
            eng.step(params, state, t=ROUND_T)
        return eng, rec, time.perf_counter() - t0
    finally:
        mesh_lib.destroy_local_group()


def _wire_checks(eng, rec, label: str) -> tuple:
    """(report fields, violations) of a recorded round: the plan's wire
    collective carries bytes, an int wire carries int8, and the C3 ledger
    (:func:`repro_torch.analysis.costmodel.collective_ledger`) is clean."""
    from repro_torch.analysis.costmodel import collective_ledger
    from repro_torch.launch.hlo_analysis import collective_bytes

    meta = eng.audit_meta()
    wire = tuple(meta["wire_collective"] or ())
    records = [c for _, c in rec.collectives]
    on_wire = [c for c in records if c.kind in wire]
    dtypes = sorted({d for c in on_wire for d in c.dtypes})
    fields = dict(collectives={k: v for k, v in collective_bytes(
        records).items() if v}, wire=list(wire), wire_dtypes=dtypes)
    violations = []
    if not sum(c.nbytes for c in on_wire):
        violations.append(f"layout: no {wire} bytes in the {label} round: "
                          "the wire collective vanished")
    if (meta.get("codec") or "").startswith("int8") and "int8" not in dtypes:
        violations.append(f"layout: {wire} carries {dtypes} but no int8: "
                          "the int8 wire was decoded before the collective")
    ledger, c3 = collective_ledger(meta, records, f"multichip:{label}")
    fields["ledger"] = {"priced_bytes": ledger.priced_bytes,
                        "control_bytes": ledger.control_bytes,
                        "unpriced_bytes": ledger.unpriced_bytes}
    violations += [f"C3: {f.message}" for f in c3]
    return fields, violations


def dry_run_sharded(k: int = 4096, *, num_blocks: int = 8,
                    codec: str = "int8", n: int = 64, verbose=True) -> dict:
    """One masked sharded round at K = ``k`` on a fake group of
    ``num_blocks`` ranks (the JAX package's ``dry_run_sharded``, which
    compiles for forced host devices): H1, no (K, K) buffer among the
    shapes the round's ops produced
    (:func:`repro_torch.launch.hlo_analysis.square_buffers`); the wire
    collective present and an int8 wire carrying int8; the C3 ledger
    clean. The JAX harness's donation check (JX3) is not made here: the
    round is stepped once, outside any program."""
    from repro_torch.launch.hlo_analysis import square_buffers

    eng, rec, secs = _masked_round_records(
        topo_lib.ring(k), "sharded", codec, num_blocks, n,
        num_blocks=num_blocks)
    fields, violations = _wire_checks(eng, rec, f"sharded/{codec}")
    squares = square_buffers(rec.shapes, k)
    violations = [f"H1: ({d}, {d}) {dt} buffer ({b / 1e6:.0f} MB) in the "
                  f"MASKED sharded round at K={k}"
                  for dt, d, b in squares] + violations
    report = dict(plan="sharded", k=k, num_blocks=num_blocks, codec=codec,
                  dropout_p=DROPOUT_P, seconds=round(secs, 2),
                  square_buffers=squares, violations=violations, **fields)
    if verbose:
        print(f"== sharded K={k} blocks={num_blocks} codec={codec} "
              f"p={DROPOUT_P}: collectives {report['collectives']} wire "
              f"{report['wire']}:{report['wire_dtypes']}; square buffers "
              f">= {k}: {squares or 'none'}")
    return report


def dry_run_distributed(k: int = 8, *, codec: str = "int8", n: int = 64,
                        verbose=True) -> dict:
    """One masked distributed round, one agent a rank of a fake group of
    ``k`` ranks (the JAX package's ``dry_run_distributed``): the p2p
    wire present, an int8 wire carrying int8, the C3 ledger clean."""
    eng, rec, secs = _masked_round_records(topo_lib.ring(k), "distributed",
                                           codec, k, n)
    fields, violations = _wire_checks(eng, rec, f"distributed/{codec}")
    report = dict(plan="distributed", k=k, codec=codec, dropout_p=DROPOUT_P,
                  seconds=round(secs, 2), violations=violations, **fields)
    if verbose:
        print(f"== distributed K={k} codec={codec} p={DROPOUT_P}: "
              f"collectives {report['collectives']} wire "
              f"{report['wire']}:{report['wire_dtypes']}")
    return report


def parity_mesh_vs_emulation(k: int = 32, *, num_blocks: int = 8,
                             codec: str = "int8", verbose: bool = True,
                             timeout_s: float = 120.0) -> dict:
    """Both multi-rank plans on a gloo group of ``num_blocks`` processes
    against their emulations without a mesh, over :data:`PARITY_ROUNDS`
    masked rounds of ``scan_rounds`` with a generator and buffered
    telemetry (:func:`parity_case`): the sharded plan over a ring of
    ``k`` agents (bit for bit), the distributed plan over a ring of
    ``num_blocks`` agents (within :func:`tolerance`). The JAX
    package's ``parity_mesh_vs_emulation`` (there on forced host
    devices), here :func:`run_parity`. Returns ``{"rounds", "rows",
    "violations"}``."""
    cases = [(topo_lib.ring(k), "sharded", codec),
             (topo_lib.ring(num_blocks), "distributed", codec)]
    try:
        rows, violations = run_parity(num_blocks, cases,
                                      timeout_s=timeout_s), []
    except RuntimeError as e:
        rows, violations = [], [f"parity: {e}"]
    if verbose:
        for row in rows:
            if row["rank"] == 0:
                print(f"== parity {row['plan']} K={row['K']}: mesh vs "
                      f"emulation over {row['rounds']} masked rounds "
                      f"max|d|={row['max_abs_err']:.2e} "
                      f"(bit_equal={row['bit_equal']}, rows equal "
                      f"{row['rows_equal']})")
    return {"rounds": PARITY_ROUNDS, "rows": rows, "violations": violations}


def lm_case_inputs(case: dict):
    """A case's config, full params (``stack_params``), tokens (B, S + 1 +
    ``serve``) and, for the encoder-decoder, frames (B, T_enc, d): drawn
    on the CPU from seed 0, the same in every process."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import get_model

    cfg = dataclasses.replace(reduced(get_arch(case["arch"])),
                              **case.get("overrides", {}))
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    full = model.stack_params(model.init(cfg, generator=gen, device="cpu"))
    toks = torch.randint(0, cfg.vocab_size,
                         (case["batch"], case["seq"] + 1 + case.get("serve", 0)),
                         generator=gen)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn(case["batch"], cfg.encdec.encoder_seq_len,
                             cfg.d_model, generator=gen)
    return cfg, full, toks, frames


def serve_logits(model, cfg, params, toks, frames, prompt: int, steps: int,
                 *, tp=None, mesh=None) -> list:
    """Last-position logits of a prefill of ``toks[:, :prompt]`` and of
    ``steps`` decode steps fed ``toks[:, prompt + i]`` (teacher forcing),
    from fresh caches (on a mesh: this rank's shards by the table)."""
    from repro_torch.sharding import parallel

    caches = model.init_cache(cfg, toks.shape[0], prompt + steps,
                              device=toks.device)
    if mesh is not None:
        caches = parallel.shard_cache(caches, mesh)
    kw = {} if tp is None else {"tp": tp}
    out = []
    with torch.no_grad():
        f = {} if frames is None else {"embeddings": frames}
        logits, caches, _ = model.forward(params, cfg, toks[:, :prompt],
                                          caches=caches, cache_index=0,
                                          last_only=True, **f, **kw)
        out.append(logits[:, -1].float().cpu().numpy())
        for i in range(steps):
            logits, caches, _ = model.forward(
                params, cfg, toks[:, prompt + i:prompt + i + 1],
                caches=caches, cache_index=prompt + i, **kw)
            out.append(logits[:, -1].float().cpu().numpy())
    return out


def lm_mesh_case(mesh, case: dict) -> dict:
    """One LM case on a data x model ``mesh`` (the tensor- and
    data-parallel forward of every LM family, :mod:`repro_torch.sharding.
    parallel`), this rank's view: ``case`` names a reduced arch (``arch``,
    field ``overrides``) and the batch (``batch`` x ``seq``). Every rank
    draws the same full params and batch on the CPU
    (:func:`lm_case_inputs`), takes its shards by the table and its rows
    of the batch, and returns its rows' logits, the full gradient
    (gathered), the loss and gradient norm one ``make_train_step`` on the
    mesh reports, for an MoE arch ``moe_block_distributed`` of layer 0 on
    its rows of ``moe_x``, and with ``serve`` > 0 its rows' logits of a
    prefill of ``seq`` tokens and ``serve`` decode steps from caches
    sharded by the table (:func:`serve_logits`)."""
    from repro_torch.data.pipeline import sharded_batch
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import moe, transformer
    from repro_torch.models.api import get_model, lm_loss
    from repro_torch.sharding import parallel

    cfg, full, toks, frames = lm_case_inputs(case)
    model = get_model(cfg)
    S = case["seq"]
    local, specs = parallel.shard_params(full, cfg, mesh)
    tokens, labels = sharded_batch(toks[:, :S], toks[:, 1:S + 1], mesh)
    rows_all, _ = sharded_batch(toks, toks, mesh)
    kw = {}
    if frames is not None:
        kw["embeddings"], _ = sharded_batch(frames, frames, mesh)
    tp = parallel.TensorParallel(mesh, specs)
    with torch.no_grad():
        logits, _, _ = model.forward(local, cfg, tokens, tp=tp, **kw)
    batch = dict(tokens=tokens, labels=labels)
    if frames is not None:
        batch["frames"] = kw["embeddings"]
    _, grads = value_and_grad(
        lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"],
                             embeddings=b.get("frames"), tp=tp),
        local, batch)
    for g in grads.values():
        parallel.sum_over_data(g, mesh)
    full_grads = parallel.gather_params(grads, specs, mesh)
    step, opt = make_train_step(cfg, mesh=mesh, specs=specs)
    _, _, metrics = step(dict(local), opt.init(local), batch)
    row = dict(arch=case["arch"], data_rank=mesh.get_local_rank("data"),
               model_rank=mesh.get_local_rank("model"),
               logits=logits.numpy(), loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]),
               grads={k: v.numpy() for k, v in full_grads.items()},
               split={k: "model" in s for k, s in specs.items()})
    if case.get("serve"):
        row["serve"] = serve_logits(model, cfg, local, rows_all,
                                    kw.get("embeddings"), S, case["serve"],
                                    tp=tp, mesh=mesh)
    if cfg.moe is not None and "moe_x" in case:
        x = torch.from_numpy(case["moe_x"])
        rows = x.shape[0] // mesh.size(0)
        r = row["data_rank"]
        p = transformer.param_tree(local, cfg).blocks[0].mlp
        with torch.no_grad():
            y, aux = moe.moe_block_distributed(
                p, cfg, x[r * rows:(r + 1) * rows], mesh, tp=tp)
        row.update(moe_y=y.numpy(), moe_aux=float(aux))
    return row


def lm_mesh_rows(rank, world, cases, data: int, model: int) -> list:
    """One rank of :func:`run_lm_parity` on the initialised group."""
    mesh = mesh_lib.make_host_mesh(data, model, device_type="cpu")
    return [lm_mesh_case(mesh, case) for case in cases]


def run_lm_parity(cases, *, data: int = 2, model: int = 2,
                  timeout_s: float = 120.0) -> list:
    """Spawn a gloo group of ``data`` x ``model`` processes on this host
    and run :func:`lm_mesh_case` for each case in each; every rank's rows,
    in rank order (the caller holds them to the one-process port)."""
    return mesh_lib.run_on_group(data * model, lm_mesh_rows, cases, data,
                                 model, timeout_s=timeout_s)


def h1_memory(K: int = H1_K, n: int = H1_N, *, codec="int8",
              num_blocks: int = 4, device="cuda", seed: int = 0) -> dict:
    """Peak device memory one masked sharded round adds at K agents of n
    params, against 4× the population's f32 bytes; raises past it."""
    topo = topo_lib.ring(K)
    eng = masked_engine(topo, "sharded", codec, num_blocks=num_blocks)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = {"w": torch.randn((K, n), generator=gen, device=device)}
    st = eng.init_state(x)
    eng.step(x, st, t=ROUND_T)                 # lane tables built once
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = eng.step(x, st, t=ROUND_T)
    torch.cuda.synchronize(device)
    added = torch.cuda.max_memory_allocated(device) - base
    pop = K * n * 4
    row = dict(K=K, n_params=n, codec=codec, num_blocks=num_blocks,
               dropout_p=DROPOUT_P, added_bytes=int(added),
               bound_bytes=4 * pop, population_f32_bytes=pop,
               kk_f32_bytes=K * K * 4,
               finite=bool(torch.isfinite(out[0]["w"]).all()))
    if added > 4 * pop or not row["finite"]:
        raise RuntimeError(f"masked sharded round over its memory bound "
                           f"(or not finite): {row}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4,
                    help="processes of the group")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl (default): one card per process, and the H1 "
                         "memory bound on card 0; gloo: the group on the "
                         "CPU, without H1")
    ap.add_argument("--out", default="build/results/torch_multichip.json")
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count()
    if args.backend == "nccl" and cards < args.world:
        raise SystemExit(
            f"multichip: --backend nccl needs one card per process, and "
            f"this host has {cards} card(s) for --world {args.world}; pass "
            "--backend gloo to run the group on the CPU (H1 then does not "
            "run)")
    t0 = time.perf_counter()
    checks = run_mesh_checks(args.world, backend=args.backend)
    rows, fl = checks["parity"], checks["fl"]
    report = {"backend": args.backend, "parity": rows, "fl": fl,
              "seconds": time.perf_counter() - t0}
    if args.backend == "nccl":
        report["h1"] = [h1_memory(codec=c) for c in (None, "int8")]
    else:
        report["h1_not_run"] = (
            "H1 reads the card's peak allocation of one masked sharded "
            "round; the gloo group runs on the CPU, so H1 did not run")
    for row in rows:
        print(f"rank {row['rank']} {row['plan']:11s} codec={row['codec']} "
              f"K={row['K']} {row['rounds']} rounds: bit_equal="
              f"{row['bit_equal']} max err {row['max_abs_err']} (tolerance "
              f"{row['tolerance']:.3g}); rows equal {row['rows_equal']}, "
              f"disagreement {row['disagreement_of_tol']:.3g} of its "
              f"tolerance; generator equal {row['generator_equal']}")
    for row in fl:
        print(f"FL rank {row['rank']} {row['plan']:11s} codec="
              f"{row['codec']} {row['process']} K={row['K']} chunk "
              f"{row['chunk']} eval_every {row['eval_every']}: t_i "
              f"{row['rounds']}, history equal {row['history_equal']}, "
              f"params bit_equal {row['bit_equal']} (max err "
              f"{row['max_abs_err']}), {row['n_rows']} rows equal "
              f"{row['rows_equal']}, generator equal "
              f"{row['generator_equal']}, population gathers "
              f"{row['gathers']} (evaluated rounds {row['gathers_expected']})"
              f", C3 findings {len(row['c3'])}")
    for row in report.get("h1", []):
        print(f"H1 K={row['K']} N={row['n_params']} codec={row['codec']}: "
              f"added {row['added_bytes']} B <= {row['bound_bytes']} B")
    if "h1_not_run" in report:
        print(f"H1 did not run: {report['h1_not_run']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
