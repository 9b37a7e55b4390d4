"""Training launcher: the port of the JAX package's ``launch/train.py``.

Two modes:

* ``standard`` — one Adam step per batch on one card
  (:func:`repro_torch.launch.steps.make_train_step`).
* ``federated`` — the paper's decentralized protocol at LM scale: a
  population of AGENTS, each holding its own replica and a
  task-conditioned data stream, takes ``local_steps`` clipped-SGD steps
  per round and then one Eq.-(6) consensus step with its cluster
  neighbours through :class:`repro_torch.core.engine.ConsensusEngine`
  (B1/B2 on the sparse plan). No parameter server, no global all-reduce:
  the communication Eqs. (10)–(11) price.

Every LM family the JAX package trains trains here: the transformer
families (``dense``, ``moe``, ``vlm``), the hybrid, xLSTM (``ssm``) and,
in standard mode only, the encoder-decoder (``encdec``; its frames are
stub audio from :mod:`repro_torch.models.frontend`, drawn each step). Params
are each family's ``stack_params`` dict in the JAX package's leaf
structure, and the federated population holds one (K, ...) tensor per
leaf (the transformer's ``blocks.*`` leaves are (K, L, ...), the hybrid's
``periods.*`` (K, n_periods, ...), xLSTM's per-layer leaves (K, ...)), so
each codec leaf, its scale and its B1/B2 launch are the JAX package's.

The standard step and the federated round are
:func:`repro_torch.core.scanloop.donating_graph` programs built per call,
the counterparts of the JAX package's ``jax.jit`` step and its donating
round loop: on the card each is captured once into a CUDA graph and
replayed (params and optimizer state, or the population, its codec state
and the async clocks, donated: updated in place; the batch, or the
round's ``t``, link and activity rows, static inputs); on the CPU and
under ``scanloop.uncaptured()`` they run eagerly. On a meshed engine
(``train_federated(mesh=)``) each rank holds and steps its own agents,
and the round's collectives are captured with it on an NCCL group.

Usage (on the card; ``--device cpu --reduced`` for a CPU-sized run):
    PYTHONPATH=src python -m repro_torch.launch.train --mode federated \\
        --agents 4 --tasks 2 --rounds 3 --consensus-plan sparse
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as tdist

import repro_torch
from repro_torch import telemetry as telemetry_lib
from repro_torch.comms import resolve_codec, select_codec
from repro_torch.configs import get_arch, reduced
from repro_torch.core import energy, scanloop
from repro_torch.core import topology as topo_lib
from repro_torch.core.engine import (PLAN_ALIASES, PLAN_KINDS,
                                     ConsensusEngine, where_active)
from repro_torch.core.protocol import stage_generators
from repro_torch.data import TaskTokenDistribution
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import frontend
from repro_torch.models.api import get_model, lm_loss
from repro_torch.optim import clip_scale, sgd

#: the families this launcher trains (standard mode)
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")
#: the families ``train_federated`` trains: as the JAX package's, whose
#: federated loss passes no frames, so its encoder-decoder cannot run
FEDERATED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")


def init_params(cfg, generator, device):
    """Random params of ``cfg`` drawn from ``generator`` on ``device``, as
    the family's ``stack_params`` dict (the JAX leaf structure)."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name} is a {cfg.family!r} model: the trainer trains the "
            f"LM families {FAMILIES}")
    model = get_model(cfg)
    return model.stack_params(model.init(cfg, generator=generator,
                                         device=device))


def train_standard(cfg, *, steps: int, batch: int, seq: int, lr: float,
                   log_every: int = 5, seed: int = 0, device="cuda",
                   callback=None, return_state: bool = False):
    """``steps`` Adam steps (gradient clipped to norm 1) on task 0's token
    stream; an encoder-decoder also gets a batch of stub audio frames
    each step. ``callback(t, params, metrics)`` runs after each step.
    Returns ``(params, loss history)``, and Adam's state last with
    ``return_state=True``."""
    repro_torch.set_f32_matmul()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    step = train_step_program(cfg, lr=lr)
    opt_state = step.opt.init(params)
    dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=1)
    hist = []
    for t in range(steps):
        # sampled outside the step, as the reference does
        toks, labels = dist.sample(gen, 0, batch, seq)
        bd = {"tokens": toks, "labels": labels}
        if cfg.family == "encdec":
            bd["frames"] = frontend.audio_frame_embeddings(gen, cfg, batch,
                                                           device=device)
        t0 = time.time()
        (params, opt_state), m = step(params, opt_state, bd)
        hist.append(float(m["loss"]))
        if callback is not None:
            callback(t, params, m)
        if t % log_every == 0:
            print(f"step {t:4d}  loss {hist[-1]:.4f}  gnorm "
                  f"{float(m['grad_norm']):.3f}  {time.time() - t0:.2f}s")
    if return_state:
        return params, hist, opt_state
    return params, hist


def train_step_program(cfg, *, lr: float):
    """:func:`make_train_step` (Adam, gradient clipped to norm 1) as the
    launcher program ``"train_step"``: ``(params, opt_state, batch) ->
    ((params, opt_state), {"loss", "grad_norm"})``, params and optimizer
    state donated and updated in place (``in_place``: no second copy of
    the model and its moments inside the graph). Its ``opt`` attribute is
    the optimizer."""
    step, opt = make_train_step(cfg, lr=lr, clip_norm=1.0, in_place=True)

    def body(params, opt_state, batch):
        params, opt_state, m = step(params, opt_state, batch)
        return (params, opt_state), m

    prog = scanloop.donating_graph(body, donate_argnums=(0, 1),
                                   name="train_step")
    prog.opt = opt
    return prog


def train_federated(cfg, *, rounds: int, agents: int, tasks: int,
                    local_steps: int, batch: int, seq: int, lr: float,
                    consensus_every: int = 1, seed: int = 0,
                    energy_params=None, consensus_dtype=None,
                    consensus_plan: str = "auto", codec=None, mesh=None,
                    chunk: int = 1, dropout_p: float = 0.0,
                    dropout_seed: int = 0, availability=None,
                    tau=None, staleness_decay: float = 1.0,
                    telemetry=None, metrics_path=None, device="cuda",
                    return_state: bool = False, num_blocks=None):
    """Clustered federated LM training (the paper's stage 2 at LM scale).

    ``agents`` agents form ``tasks`` clusters of ``agents // tasks``;
    ``topology.clusters`` drives σ, the engine plan (``consensus_plan``:
    "auto", one of ``PLAN_KINDS`` or a JAX alias) and the Eq.-(11)
    pricing. Each round every agent takes ``local_steps`` SGD steps
    (gradient clipped to norm 1, ``(w.f32 − lr·g.f32).to(w.dtype)``) on
    its task's batches, then one ``engine.step``: through ``codec`` (a
    spec or "auto" → :func:`repro_torch.comms.select_codec`; lossy codecs
    carry error feedback), else in ``consensus_dtype`` (bf16 halves the
    sidelink bytes), else as stored. ``consensus_every`` is accepted for
    the JAX signature; there too every round mixes.

    ``dropout_p > 0`` fades sidelinks per round
    (``GraphProcess.dropout``); ``availability`` (an ``AgentProcess``)
    makes the run asynchronous: sleeping agents hold their params and
    error-feedback residuals bit for bit, awake receivers mix stale
    neighbours at ``staleness_decay ** age`` until ``tau``. The Eq.-(11)
    estimate prices the full graph.

    Round t draws its batches and codec rounding from its own generator,
    made up front from the run's, and the device is read once per
    ``chunk`` rounds (losses and ``telemetry`` rows in one copy; streaming
    telemetry also reads each row), so every chunk size gives the same
    bits. ``metrics_path`` writes a buffered telemetry JSONL log. The
    logged loss is agent 0's after mixing, on its first local batch.

    ``mesh`` (a ``DeviceMesh`` with an ``agents`` axis over the process
    group) spreads the agents over the ranks: the sharded plan a block a
    rank (``num_blocks``, the sharded plan's block count, defaults to the
    axis's size), the distributed plan one agent a rank. Each rank then
    holds only its rows (``engine.local_rows``), draws the whole
    population's batches from the round's generator as one process does
    and steps only its agents; agent 0's loss reaches every rank by one
    broadcast a round (an observer collective of ``audit_meta()``).

    Returns ``(stacked params {name: (K, ...)}, per-round losses, the
    Eq.-(11) estimate in J)``, and the codec state (error-feedback
    residuals, or None) last with ``return_state=True``; on a mesh, this
    rank's rows of both."""
    if cfg.family not in FEDERATED_FAMILIES:
        raise ValueError(
            f"{cfg.name} is a {cfg.family!r} model: train_federated trains "
            f"{FEDERATED_FAMILIES}. The JAX package's federated loss passes "
            "no frames, so its encoder-decoder finds no cross cache and "
            "fails (ROADMAP.md, C8); the port adds no feature the "
            "reference lacks. Train it with mode 'standard'")
    if agents % tasks:
        raise ValueError(f"agents={agents} is not a multiple of tasks="
                         f"{tasks}: each task's cluster needs agents // "
                         "tasks agents; pick agents = tasks * per")
    per = agents // tasks
    repro_torch.set_f32_matmul()
    topo = topo_lib.clusters(tasks, per)
    ep = energy_params or energy.paper_calibrated("fig3")
    if codec is not None:
        codec = (select_codec(topo, ep) if codec == "auto"
                 else resolve_codec(codec))
        consensus_dtype = None        # the codec defines the wire format
    graph = (topo_lib.GraphProcess.dropout(dropout_p, seed=dropout_seed)
             if dropout_p > 0 else None)
    engine = ConsensusEngine(topo, codec=codec, mesh=mesh,
                             plan=consensus_plan, graph=graph,
                             agents=availability, tau=tau,
                             staleness_decay=staleness_decay,
                             num_blocks=num_blocks)
    codec = engine.codec
    is_async = engine.agents is not None
    fading = engine.graph.kind != "static"

    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    round_gens = stage_generators(gen, rounds)
    # one row per agent this process holds (all of them without a mesh),
    # not a broadcast view: the rounds write the local steps into the
    # population in place (its buffers, donated)
    rows = engine.local_rows
    held = agents if rows is None else rows.stop - rows.start
    stacked = {n: x.expand((held,) + x.shape).clone()
               for n, x in params.items()}
    dist = TaskTokenDistribution(vocab_size=cfg.vocab_size, num_tasks=tasks)
    task_grid = (torch.arange(agents, device=device) // per)[:, None].expand(
        agents, local_steps)

    def loss_fn(p, tokens, labels):
        return lm_loss(p, cfg, tokens, labels, model=model)

    n_params = sum(x.numel() for x in params.values())
    n_bytes = sum(x.numel() * (2 if consensus_dtype is not None
                               else x.element_size())
                  for x in params.values())
    del params
    # with a codec, b(W) is the full-precision (32-bit) size price_bits
    # discounts; without one the wire is the storage (or consensus) bytes
    model_bits = (32.0 * n_params if codec is not None
                  else float(n_bytes) * 8)
    ep = dataclasses.replace(ep, model_bits=model_bits,
                             devices_per_cluster=per, B_i=local_steps)
    # one cluster's graph: per·(per−1) directed SL messages per round
    cluster_topo = topo_lib.clusters(1, per)

    tel = telemetry
    own_tel = tel is None and metrics_path is not None
    if own_tel:
        tel = telemetry_lib.Telemetry(
            sinks=(telemetry_lib.JsonlSink(metrics_path),))
    rec = tel.recorder_for(engine, ep) if tel is not None else None
    stream = (tel.stream_cb(rec, "fl")
              if tel is not None and tel.streaming else None)

    round_prog = federated_round_program(
        engine, loss_fn, dist, task_grid, batch=batch, seq=seq, lr=lr,
        consensus_dtype=consensus_dtype, recorder=rec,
        streaming=stream is not None)
    codec_state = engine.init_state(stacked)
    ast = engine.init_async_state(device=device) if is_async else None
    carry = (stacked, codec_state, *(ast if is_async else (None, None)))
    del stacked, codec_state
    hist = []
    chunk = max(int(chunk), 1)
    for start in range(0, rounds, chunk):
        n = min(chunk, rounds - start)
        ts = torch.arange(start, start + n, device=device)
        links = engine.round_survival(ts) if fading else None
        acts = engine.availability(ts) if is_async else None
        out = None
        for i in range(n):
            xs = {"t": ts[i], "link": None if links is None else links[i],
                  "act": None if acts is None else acts[i]}
            (carry,), ys = round_prog(carry, xs, round_gens[start + i])
            if out is None:
                out = torch.empty((n, ys.shape[0]), dtype=torch.float64,
                                  device=device)
            out[i].copy_(ys)       # ys live until the program's next replay
            if stream is not None:
                stream(start + i, out[i, 1:])
        host = scanloop.to_host(out)                        # one read
        if rec is not None:
            tel.record_rounds(rec, rec.unpack(host[:, 1:]), start,
                              driver="fl")
        for r, loss in enumerate(host[:, 0], start):
            hist.append(float(loss))
            print(f"round {r:3d}  loss {float(loss):.4f}")
    stacked, codec_state = carry[:2]
    # Eq.-(11) priced at the codec's wire size (b(W) · bits ratio)
    E = tasks * energy.fl_energy(ep, rounds, topology=cluster_topo,
                                 codec=codec)
    wire_mb = (codec.price_bits(model_bits) / 8e6 if codec is not None
               else n_bytes / 1e6)
    print(f"estimated FL energy for {rounds} rounds x {tasks} clusters: "
          f"{E / 1e3:.2f} kJ ({wire_mb:.2f} MB per exchange"
          f"{', codec ' + codec.name if codec is not None else ''})")
    if tel is not None:
        n_ev = len(tel.events(driver="fl"))
        print(f"telemetry: {n_ev} round events, measured comm energy "
              f"{tel.joules() / 1e3:.2f} kJ (per-round Eq.-11 ledger)")
        if own_tel:
            tel.close()
    if return_state:
        return stacked, hist, E, codec_state
    return stacked, hist, E


def federated_round(engine, loss_fn, dist, task_grid, *, batch: int,
                    seq: int, lr: float, consensus_dtype=None,
                    recorder=None):
    """The round function of :func:`train_federated`: ``(carry, xs,
    generator) -> ((carry,), row)``, ``carry`` = (population, codec state,
    async clocks, wire ages; the last two None on lockstep engines), ``xs``
    the round's ``t``, link survival and activity rows (None where the
    engine draws none) and ``generator`` the round's. Each agent's batches
    of ``task_grid``'s tasks are drawn from ``generator``, then
    :func:`fl_round` and the logged loss (agent 0's after mixing, on its
    first local batch); ``row`` is one float64 row: that loss, then the
    ``recorder``'s packed telemetry row.

    On a meshed engine the population and codec state are this rank's
    rows (``engine.local_rows``): the whole population's batches are
    drawn, as one process draws them, and the rank keeps its rows and
    steps its agents; the clocks and the row read the whole population's
    activity. The rank holding agent 0 computes the loss and broadcasts
    it over the agent axis (``audit_meta()``'s observer "logged loss of
    agent 0")."""
    is_async = engine.agents is not None
    rows, group = engine.local_rows, engine.group
    owner = rows is None or rows.start == 0        # holds agent 0

    def one_round(carry, xs, g):
        stacked, codec_state, clock, age = carry
        link = xs["link"]
        if is_async:
            # one availability draw per round, shared between the
            # staleness weights, the per-agent hold and the row
            ar = engine.async_round(xs["t"], age, act=xs["act"], link=link)
            sv, act, deliv = ar.weights, ar.act, ar.delivered
        else:
            sv, act, deliv = link, None, link
        toks, labels = dist.sample_traced(g, task_grid, batch, seq)
        first, mine = (toks[0, 0], labels[0, 0]), act
        if rows is not None:
            toks, labels = toks[rows], labels[rows]
            mine = None if act is None else act[rows]
        stacked, codec_state = fl_round(
            engine, loss_fn, stacked, codec_state, g, toks, labels,
            lr=lr, survival=sv, act=mine, consensus_dtype=consensus_dtype)
        with torch.no_grad():
            if owner:
                loss = loss_fn({name: x[0] for name, x in stacked.items()},
                               *first).to(torch.float32)
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=first[0].device)
        if group is not None:
            tdist.broadcast(loss, src=tdist.get_global_rank(group, 0),
                            group=group)
        if is_async:
            clock, age = clock + act.to(clock.dtype), ar.age
        cols = [loss.to(torch.float64)[None]]
        if recorder is not None:
            cols.append(recorder.pack([recorder.row(
                stacked, deliv, metric=loss, reached=False, live=True,
                active=act, age=ar.age if is_async else None)])[0])
        return ((stacked, codec_state, clock, age),), torch.cat(cols)

    return one_round


def federated_round_program(engine, loss_fn, dist, task_grid, *,
                            streaming: bool = False, **kw):
    """:func:`federated_round` as the launcher program
    ``"train_fl_round"``, its carry (argument 0) donated; on a meshed
    engine the carry is this rank's rows and the round's collectives run
    on the agent axis's group, captured with it on NCCL."""
    one_round = federated_round(engine, loss_fn, dist, task_grid, **kw)
    prog = scanloop.donating_graph(one_round, donate_argnums=(0,),
                                   name="train_fl_round", group=engine.group)
    prog.record.streaming = bool(streaming)
    # the carry holds the AsyncState's clock and ages
    prog.record.async_argnums = (0,) if engine.agents is not None else ()
    return prog


def local_round(loss_fn, stacked, tokens, labels, *, lr: float,
                act=None):
    """Every agent's local steps, agent by agent: agent k takes one
    clipped-SGD step (gradient clipped to norm 1, then ``(w.f32 −
    lr·g.f32).to(w.dtype)``: ``optim.sgd``'s ``apply``) per batch
    ``tokens[k, s]`` (``tokens`` (K, steps, B, S)). Returns the new
    population; an agent asleep in the (K,) bool ``act`` keeps its params
    bit for bit. ``apply`` scales and frees the gradient leaf by leaf, so
    one agent's step holds its gradient once, not clipped and unclipped
    together. Agent k's new params overwrite its row of ``stacked`` (read
    by no later agent), so the round holds one population, not two; a
    leaf broadcast over the agents (one row for all, as ``expand`` makes)
    is copied to one row per agent first."""
    opt = sgd(lr)
    new = {name: x.clone() if x.shape[0] > 1 and x.stride(0) == 0 else x
           for name, x in stacked.items()}
    for k in range(tokens.shape[0]):
        p = {name: x[k] for name, x in stacked.items()}
        state = opt.init(p)
        for s in range(tokens.shape[1]):
            _, grads = value_and_grad(loss_fn, p, tokens[k, s], labels[k, s])
            scale, _ = clip_scale(grads, 1.0)
            p, state = opt.apply(grads, state, p, scale)
        for name, w in p.items():
            new[name][k] = (w if act is None else
                            torch.where(act[k], w, new[name][k]))
    return new


def fl_round(engine, loss_fn, stacked, codec_state, generator, tokens,
             labels, *, lr: float, survival=None, act=None,
             consensus_dtype=None):
    """One federated round: :func:`local_round`, then one
    ``engine.step`` through the engine's codec (``generator`` drives its
    stochastic rounding), else in ``consensus_dtype``, else as stored.
    ``survival`` is the round's plan-shaped link survival or staleness
    weights, ``act`` the (K,) activity of an async round: a sleeping
    agent's params and codec residuals hold bit for bit.

    ``stacked`` is consumed: its tensors take the local steps' result
    (:func:`local_round`) and the dict is emptied. Returns ``(new
    population, codec state)``."""
    new = local_round(loss_fn, stacked, tokens, labels, lr=lr, act=act)
    stacked.clear()
    pre = new
    if engine.codec is not None:
        old_state = codec_state
        new, codec_state = engine.step(new, codec_state, generator,
                                       survival=survival)
        if act is not None and codec_state is not None:
            codec_state = _hold(act, codec_state, old_state)
        del old_state
    elif consensus_dtype is not None:
        mixed, _ = engine.step(
            {name: x.to(consensus_dtype) for name, x in new.items()},
            survival=survival)
        new = {name: m.to(pre[name].dtype) for name, m in mixed.items()}
        del mixed
    else:
        new, _ = engine.step(new, survival=survival)
    if act is not None:
        new = _hold(act, new, pre)                  # sleeping receivers
    return new, codec_state


def _hold(act, new, old):
    """:func:`where_active` one leaf at a time, dropping each ``new`` leaf
    as its replacement is made (one leaf's transient, not a population's)."""
    out = {}
    for name in list(new):
        out[name] = where_active(act, {name: new.pop(name)},
                                 {name: old[name]})[name]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["standard", "federated"],
                    default="standard")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--tasks", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bf16-consensus", action="store_true")
    ap.add_argument("--consensus-plan",
                    choices=["auto"] + list(PLAN_KINDS) + list(PLAN_ALIASES),
                    default="auto",
                    help="consensus execution plan (repro_torch.core.engine)")
    ap.add_argument("--codec", default=None,
                    help="model-exchange codec spec (bf16, int8, int4, "
                         "int8:b64 block scales, topk:0.05, +ef suffix; "
                         "'auto' picks from link quality; see "
                         "repro_torch.comms)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="FL rounds between two device reads (the same "
                         "bits at every chunk size)")
    ap.add_argument("--dropout-p", type=float, default=0.0,
                    help="per-round sidelink failure probability "
                         "(repro_torch.core.topology.GraphProcess)")
    ap.add_argument("--dropout-seed", type=int, default=0)
    ap.add_argument("--availability-p", type=float, default=None,
                    help="per-round agent wake probability: a Bernoulli "
                         "AgentProcess; sleeping agents skip local SGD "
                         "and mixing")
    ap.add_argument("--availability-seed", type=int, default=0)
    ap.add_argument("--tau", type=float, default=None,
                    help="hard staleness bound in rounds (default: none)")
    ap.add_argument("--staleness-decay", type=float, default=1.0,
                    help="per-round age decay of a stale wire's weight")
    ap.add_argument("--metrics", default=None, metavar="OUT.JSONL",
                    help="write a per-round telemetry event log (JSONL; "
                         "see repro_torch.telemetry.schema)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.mode == "standard":
        train_standard(cfg, steps=args.steps, batch=args.batch,
                       seq=args.seq, lr=args.lr, device=args.device)
    else:
        train_federated(
            cfg, rounds=args.rounds, agents=args.agents, tasks=args.tasks,
            local_steps=args.local_steps, batch=args.batch, seq=args.seq,
            lr=args.lr,
            consensus_dtype=torch.bfloat16 if args.bf16_consensus else None,
            consensus_plan=args.consensus_plan, codec=args.codec,
            chunk=args.chunk, dropout_p=args.dropout_p,
            dropout_seed=args.dropout_seed,
            availability=(topo_lib.AgentProcess.bernoulli(
                args.availability_p, seed=args.availability_seed)
                if args.availability_p is not None else None),
            tau=args.tau, staleness_decay=args.staleness_decay,
            metrics_path=args.metrics, device=args.device)


if __name__ == "__main__":
    main()
