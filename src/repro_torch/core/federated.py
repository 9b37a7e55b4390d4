"""Federated-learning runtimes: the decentralized per-cluster FL of the
paper (Sect. II-B), a FedAvg star-topology baseline, and the round
drivers that run FL until a task reaches its target (the paper's t_i).

The drivers run rounds in a host loop that reads the device once per
``chunk`` rounds: each round's reached flag stays on the device, a round
after the hit is computed and then discarded (``torch.where`` on the
live flag keeps params, error-feedback state and the async carry as they
were), and the host reads the chunk's flags, metrics and telemetry rows
in one copy to recover t_i with ``first_hit``. So params, t_i, history
and codec state are the same bits at every chunk size; a chunk ending
after the hit only costs the discarded rounds' compute (and their kernel
launches).

Each round is one replay of a round program (:func:`fl_round_program`,
a :func:`repro_torch.core.scanloop.donating_graph`): on the card the
round's launches are captured once into a CUDA graph and replayed with
one host call a round, the carry (params, codec state, async clock and
ages, reached flag) updated in place. :func:`run_fl_until` and
:func:`run_fl_until_scan` fetch their program from the program cache.

On an engine whose agents are spread over the ranks of a process group
(``engine.local_rows`` is not None: the sharded plan with a block a rank,
the distributed plan with one agent a rank) every rank runs the driver on
its own rows: ``stacked_params`` and the returned params and codec state
are the rank's rows, ``sample_batches`` still returns the whole
population's batches (drawn as in one process, so the generator stays in
step with the one-process run) and the driver keeps its rows of them.
``target_fn`` is called on the whole population: on each round the
``eval_every`` grid evaluates, ONE gather over the agent axis
(:func:`repro_torch.core.consensus.gather_population`) gives every rank the
one-process run's bits, so every rank reaches the same verdict in the
same round without a vote; rounds the grid skips issue no collective. The
meshed round is the same cached program, its collectives captured with it
on an NCCL group.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.func import grad, vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import consensus, scanloop
from repro_torch.core.engine import AsyncState, ConsensusEngine, where_active


def local_steps(loss_fn, params, batches, lr: float):
    """B_i local SGD steps on one device (``batches`` has a leading step
    axis)."""
    steps = tree_leaves(batches)[0].shape[0]
    for i in range(steps):
        b = tree_map(lambda x: x[i], batches)
        g = grad(loss_fn)(params, b)
        params = {k: (w.to(torch.float32) - lr * g[k].to(torch.float32)
                      ).to(w.dtype) for k, w in params.items()}
    return params


def decentralized_fl_round(loss_fn, stacked_params, stacked_batches,
                           engine, lr: float, codec=None, codec_state=None,
                           generator=None, *, t=None, mask=None,
                           survival=None, active=None):
    """One FL round, Eq. (6): per-agent local SGD (``torch.func.vmap``
    over the leading agent axis K), then one consensus step.

    ``engine``: a :class:`ConsensusEngine`, or a (K, K) σ / Topology that
    is wrapped into one (``codec`` then applies to it). With a codec the
    result is ``(params, codec_state)``, without one the params.
    ``generator`` enables stochastic rounding. ``t`` / ``mask`` /
    ``survival`` pass the round's edge survival to ``engine.step``
    (time-varying graphs; see there). ``active`` (async engines): the
    round's (K,) activity from ``engine.async_round`` — inactive agents
    keep their pre-round params (their local SGD is discarded bit for
    bit) and their post-mix params and codec residuals hold too; pass
    the matching ``survival=round.weights`` alongside it.

    On a meshed engine (``engine.local_rows`` not None) ``stacked_params``
    and ``codec_state`` are this rank's rows, while ``stacked_batches``
    and ``active`` cover the whole population (every rank draws them
    alike): the round keeps the rank's rows of both."""
    engine = ConsensusEngine.wrap(engine, codec=codec)
    rows = engine.local_rows
    if rows is not None:
        n = tree_leaves(stacked_batches)[0].shape[0]
        if n != engine.K:
            raise ValueError(
                f"on the {engine.plan.kind!r} plan over a mesh the round "
                f"takes the whole population's batches (leading axis "
                f"K={engine.K}) and keeps rows {rows.start}:{rows.stop}, "
                f"got a leading axis of {n}")
        stacked_batches = tree_map(lambda b: b[rows], stacked_batches)
        if active is not None:
            active = active[rows]
    new_params = vmap(lambda p, b: local_steps(loss_fn, p, b, lr))(
        stacked_params, stacked_batches)
    if active is not None:
        new_params = where_active(active, new_params, stacked_params)
    params, state = engine.step(new_params, codec_state, generator, t=t,
                                mask=mask, survival=survival)
    if active is not None:
        params = where_active(active, params, new_params)
        if state is not None:
            old = (codec_state if codec_state is not None
                   else engine.init_state(new_params))
            state = where_active(active, state, old)
    if engine.codec is None:
        return params
    return params, state


def fedavg_round(loss_fn, global_params, stacked_batches, weights,
                 lr: float):
    """Star-topology FedAvg baseline: the server broadcasts, K devices
    run their local steps, the server takes the data-size-weighted
    average. ``weights``: (K,) data sizes."""
    K = weights.shape[0]
    stacked = {k: v.unsqueeze(0).expand((K,) + v.shape)
               for k, v in global_params.items()}
    locals_ = vmap(lambda p, b: local_steps(loss_fn, p, b, lr))(
        stacked, stacked_batches)
    w = (weights / weights.sum()).to(torch.float32)
    return {k: torch.einsum("k,k...->...", w, x.to(torch.float32)
                            ).to(x.dtype) for k, x in locals_.items()}


def population_stand_in(stacked_params, engine):
    """A (K, ...) population built from this rank's rows alone (its rows
    repeated), for probing ``target_fn`` on a meshed engine without a
    gather: the probe's call is real, and a gather there would be a
    collective the run does not make."""
    K = engine.K

    def whole(x):
        reps = -(-K // x.shape[0])
        return x.repeat((reps,) + (1,) * (x.dim() - 1))[:K]

    return {k: whole(v) for k, v in stacked_params.items()}


def fl_round_program(engine, update, evaluate, *, recorder=None,
                     keep_delivered: bool = False,
                     host_fns=(), streaming: bool = False):
    """One FL round as a :func:`repro_torch.core.scanloop.donating_graph`
    program: the round the chunked loop (:func:`run_chunked_rounds`)
    replays, one CUDA graph per variant on the card.

    ``update(t, params, state, survival, active, generator, batches) ->
    (new_params, new_state)`` computes round ``t``'s local SGD and
    consensus from the carried params and codec state (``None`` without
    a stateful codec), given the round's plan-shaped link survival or
    staleness weights, on async engines the (K,) activity, and
    ``batches`` when the sampler runs on the host (else ``None``).
    ``evaluate(new_params, generator) -> (hit, metric)`` (0-d tensors)
    checks the target inside the round; ``None`` when the target runs on
    the host between the ``update`` and ``commit`` variants.

    The program is ``fl_round(carry, xs, generator, variant)`` with
    ``carry = (params, state, clock, age, reached)`` donated (the
    :class:`AsyncState` clock and ages are ``None`` on lockstep engines),
    ``xs`` the round's inputs (``t``, ``link``, ``act``, ``batches``; and
    ``new``, ``new_st``, ``hit``, ``metric`` for ``commit``) and
    ``variant`` one of ``"eval"`` (a round the ``eval_every`` grid
    evaluates), ``"skip"`` (one it skips: no evaluation, metric 0),
    ``"update"`` (the round up to its new params, carry untouched) and
    ``"commit"`` (the rest, from the host target's verdict). It returns
    ``((carry,), ys)``: ``ys`` one float64 row, the reached flag, the
    evaluated flag and the metric, then the delivered lanes
    (``keep_delivered`` on fading or async engines) and the packed
    telemetry row (``recorder``). A round after the hit is computed and
    discarded with ``torch.where`` on the live flag (params, codec state,
    clock and ages; its telemetry row becomes
    :meth:`RoundRecorder.frozen_row`).

    On a meshed engine (``engine.local_rows`` set) the program's carry is
    this rank's rows, and its body's collectives (the consensus wire,
    ``evaluate``'s population gather, the row's disagreement all-reduces)
    run on the agent axis's group: captured with the round on NCCL
    (``scanloop.donating_graph(group=)``)."""
    is_async = engine.agents is not None
    keep = keep_delivered and (is_async or engine.graph.kind != "static")
    f64 = torch.float64

    def fl_round(carry, xs, generator, variant):
        params, st, clock, age, reached = carry
        t, link, act = xs["t"], xs["link"], xs["act"]
        if is_async:
            # one availability draw per round, shared between the
            # staleness weights, the per-agent freeze and the row (which
            # bills only DELIVERED wires)
            ar = engine.async_round(t, age, act=act, link=link)
            sv, a, deliv = ar.weights, ar.act, ar.delivered
        else:
            sv, a, deliv = link, None, link
        if variant == "commit":
            new, new_st = xs["new"], xs["new_st"]
            hit, metric = xs["hit"], xs["metric"]
        else:
            new, new_st = update(t, params, st, sv, a, generator,
                                 xs["batches"])
            if variant == "update":
                return (carry,), {"new": new, "new_st": new_st}
            if variant == "eval":
                hit, metric = evaluate(new, generator)
            else:
                # off-grid rounds skip the evaluation entirely
                hit = torch.zeros((), dtype=torch.bool, device=reached.device)
                metric = torch.zeros((), dtype=torch.float32,
                                     device=reached.device)
        evaluated = variant != "skip"
        live = ~reached
        row = None
        if recorder is not None:
            row = recorder.live_row(live, recorder.row(
                new, deliv, metric=metric, reached=hit, live=True,
                active=a, age=ar.age if is_async else None))
        params = where_active(live, new, params)
        if new_st is not None:
            st = where_active(live, new_st, st)
        if is_async:
            clock = torch.where(live, clock + a.to(clock.dtype), clock)
            age = torch.where(live, ar.age, age)
        reached = reached | (live & hit)
        # a discarded round reports the carried reached flag (True), is
        # not evaluated and has metric 0, as the JAX freeze does
        cols = [torch.stack([reached.to(f64), (live & evaluated).to(f64),
                             torch.where(live, metric.to(f64), 0.0)])]
        if keep:
            cols.append(deliv.flatten().to(f64))
        if row is not None:
            cols.append(recorder.pack([row])[0])
        return ((params, st, clock, age, reached),), torch.cat(cols)

    prog = scanloop.donating_graph(fl_round, donate_argnums=(0,),
                                   name="fl_chunk", group=engine.group)
    prog.record.host_fns = tuple(host_fns)
    prog.record.streaming = bool(streaming)
    # the carry (argument 0) holds the AsyncState's clock and ages
    prog.record.async_argnums = (0,) if is_async else ()
    return prog


def run_chunked_rounds(engine, program, params, *, max_rounds: int,
                       chunk: int, generator=None, sampler=None,
                       target=None, evaluates=None, telemetry=None,
                       telemetry_extra=None, keep_delivered: bool = False):
    """The chunked loop every FL driver runs (:func:`run_fl_until`,
    :func:`run_fl_until_scan` and the case study's adaptation): round
    ``t`` replays ``program`` (:func:`fl_round_program`).

    ``sampler(generator, t)`` (a sampler that failed the capture probe)
    runs on the host before each round, its batches copied into the
    round's inputs; ``target(new_params) -> (reached, metric)`` (a target
    that failed it) runs between the round's ``update`` and ``commit``
    variants. ``evaluates(t)`` says which rounds the ``eval_every`` grid
    evaluates (default: all).

    Per chunk: the engine's draws in one vectorised call each, one replay
    a round (plus the host functions), each round's row copied into the
    chunk's buffer, then ONE device→host read of the reached flags, the
    evaluated mask, the metrics, the delivered lanes (``keep_delivered``)
    and the telemetry rows; the loop ends after the chunk in which a round
    hit. Rounds after the hit are computed and discarded with
    ``torch.where`` on the device-side live flag, so every chunk size
    gives the same bits. Rounds past ``max_rounds`` are never computed:
    the last chunk is cut short instead.

    Returns ``(params, state, rounds_used, history, delivered,
    async_state)``; ``delivered`` is a host bool array ``(rounds_used,) +
    lane shape`` of the wires the device delivered when ``keep_delivered``
    is set and links fade or agents sleep, else ``None``;
    ``async_state`` the final :class:`AsyncState` on async engines, else
    ``None``."""
    params = scanloop.own(params)
    device = next(iter(params.values())).device
    is_async = engine.agents is not None
    fading = engine.graph.kind != "static"
    keep = keep_delivered and (is_async or fading)
    clock, age = (engine.init_async_state(device=device) if is_async
                  else (None, None))
    reached = torch.zeros((), dtype=torch.bool, device=device)
    carry = (params, engine.init_state(params), clock, age, reached)
    recorder = (telemetry.recorder_for(engine) if telemetry is not None
                else None)
    stream = (telemetry.stream_cb(recorder, "fl", telemetry_extra)
              if telemetry is not None and telemetry.streaming else None)
    chunk = max(1, min(int(chunk), max_rounds))
    history, delivered, rounds_used = [], [], max_rounds
    lane_shape = ()
    for start in range(0, max_rounds, chunk):
        n = min(chunk, max_rounds - start)
        # the chunk's draws, one vectorised call each on the device
        ts = torch.arange(start, start + n, device=device)
        links = engine.round_survival(ts) if fading else None
        acts = engine.availability(ts) if is_async else None
        if keep:
            lane_shape = tuple(age.shape if is_async else links.shape[1:])
        lanes = math.prod(lane_shape) if keep else 0
        out = None
        for i in range(n):
            t = start + i
            xs = {"t": ts[i], "link": None if links is None else links[i],
                  "act": None if acts is None else acts[i],
                  "batches": (None if sampler is None
                              else sampler(generator, t))}
            if evaluates is not None and not evaluates(t):
                (carry,), ys = program(carry, xs, generator, "skip")
            elif target is None:
                (carry,), ys = program(carry, xs, generator, "eval")
            else:
                (carry,), staged = program(carry, xs, generator, "update")
                r, metric = target(staged["new"])
                xs = dict(xs, batches=None, new=staged["new"],
                          new_st=staged["new_st"],
                          hit=torch.as_tensor(r, device=device).to(
                              torch.bool),
                          metric=torch.as_tensor(metric, device=device
                                                 ).reshape(()))
                (carry,), ys = program(carry, xs, generator, "commit")
            if out is None:
                out = torch.empty((n, ys.shape[0]), dtype=torch.float64,
                                  device=device)
            out[i].copy_(ys)
            if stream is not None:
                stream(t, out[i, 3 + lanes:])
        host = scanloop.to_host(out)                        # one read
        if keep:
            delivered.extend(host[:, 3:3 + lanes] > 0)
        if recorder is not None:
            telemetry.record_rounds(
                recorder, recorder.unpack(host[:, 3 + lanes:]), start,
                driver="fl", extra=telemetry_extra)
        history.extend(float(m) for m, v in zip(host[:, 2], host[:, 1]) if v)
        h = scanloop.first_hit(host[:, 0] > 0)
        if h is not None:
            rounds_used = start + h + 1
            break
    params, st, clock, age = scanloop.own(carry[:4])
    delivered = (np.stack(delivered[:rounds_used]).reshape(
        (rounds_used,) + lane_shape) if keep else None)
    return (params, st, rounds_used, history, delivered,
            AsyncState(clock, age) if is_async else None)


def _fl_program(loss_fn, sample_batches, target_fn, engine, lr, *,
                has_codec, recorder, host_fns, streaming):
    """The FL round of Eq. (6) as a program (:func:`fl_round_program`):
    ``sample_batches`` inside the round unless it is None (it then runs
    on the host), :func:`decentralized_fl_round`, and ``target_fn``
    inside the round unless it is None."""
    def update(t, p, st, sv, act, generator, batches):
        if batches is None:
            batches = sample_batches(generator, t)
        out = decentralized_fl_round(
            loss_fn, p, batches, engine, lr, codec_state=st,
            generator=generator if has_codec else None, survival=sv,
            active=act)
        return out if has_codec else (out, None)

    def evaluate(new, _generator):
        if engine.local_rows is not None:
            # the whole population, on every rank: one gather a round the
            # grid evaluates
            new = consensus.gather_population(new, engine.mesh,
                                              engine.plan.axis_name)
        r, metric = target_fn(new)
        device = next(iter(new.values())).device
        return (torch.as_tensor(r, device=device).to(torch.bool),
                torch.as_tensor(metric, device=device).reshape(()))

    return fl_round_program(
        engine, update, None if target_fn is None else evaluate,
        recorder=recorder, host_fns=host_fns, streaming=streaming)


def _run_fl_chunked(loss_fn, stacked_params, sample_batches, engine, lr, *,
                    target_fn, max_rounds, generator, eval_every, codec,
                    chunk, return_state, telemetry=None,
                    telemetry_extra=None):
    """:func:`run_chunked_rounds` with the round of Eq. (6):
    ``sample_batches``, :func:`decentralized_fl_round` and ``target_fn``
    on the ``eval_every`` grid.

    The round program comes from the program cache
    (:func:`repro_torch.core.scanloop.cached_program`), keyed on the JAX
    package's key: the loss, sampler and target by identity, the engine
    (its plan, codec, graph and agent processes), ``lr``, ``max_rounds``,
    ``eval_every`` and the params' tree signature, plus
    ``telemetry.trace_signature()`` when telemetry is on, so Monte-Carlo
    repetitions of one configuration replay ONE captured graph. A hit
    skips the capture probes. A sampler or target that fails the probe
    (:func:`repro_torch.core.scanloop.traceable`) runs on the host each
    round, and its program is built per call and never admitted to the
    cache; so is a streaming-telemetry program.

    A meshed engine (``engine.local_rows`` is not None) takes the same
    key (the engine's identity covers its mesh) and the same program: the
    sampler inside the round, and ``target_fn`` inside the ``eval``
    variant on the gathered population
    (:func:`repro_torch.core.consensus.gather_population`). The target is
    probed on :func:`population_stand_in`, not on a gather, and the ranks
    take the least of their verdicts (``scanloop.agree``), so every rank
    builds the same program."""
    engine = ConsensusEngine.wrap(engine, codec=codec)
    has_codec = engine.codec is not None
    streaming = telemetry is not None and telemetry.streaming
    recorder = (telemetry.recorder_for(engine) if telemetry is not None
                else None)
    meshed = engine.local_rows is not None
    program = None
    key = ("fl_chunk", loss_fn, sample_batches, target_fn, engine,
           float(lr), int(max_rounds), int(eval_every),
           scanloop.tree_signature(stacked_params))
    if telemetry is not None:
        key = key + (telemetry.trace_signature(),)
    if not streaming:
        program = scanloop.get_cached_program(key)
    s_ok = t_ok = program is not None          # hit: the probes passed
    if program is None:
        device = next(iter(stacked_params.values())).device
        _, s_ok = scanloop.traceable(
            sample_batches, generator,
            torch.zeros((), dtype=torch.int64, device=device),
            name="sample_batches")
        _, t_ok = scanloop.traceable(
            target_fn, population_stand_in(stacked_params, engine)
            if meshed else stacked_params, name="target_fn")
        if meshed:
            s_ok, t_ok = map(bool, scanloop.agree(engine.group,
                                                  [s_ok, t_ok]))
        host = tuple(n for n, ok in (("sample_batches", s_ok),
                                     ("target_fn", t_ok)) if not ok)

        def build():
            return _fl_program(
                loss_fn, sample_batches if s_ok else None,
                target_fn if t_ok else None, engine, lr,
                has_codec=has_codec, recorder=recorder, host_fns=host,
                streaming=streaming)

        # streaming telemetry and host round functions: built per call,
        # never cached (the JAX package's JX1/JX4 domain)
        program = (build() if streaming or host
                   else scanloop.cached_program(key, build))

    def host_target(new):
        # target_fn sees the whole population, on a mesh too
        return target_fn(consensus.gather_population(
            new, engine.mesh, engine.plan.axis_name) if meshed else new)

    p, st, rounds_used, history, _, _ = run_chunked_rounds(
        engine, program, stacked_params, max_rounds=max_rounds,
        chunk=chunk, generator=generator,
        sampler=None if s_ok else sample_batches,
        target=None if t_ok else host_target,
        evaluates=lambda t: eval_every == 1 or (t + 1) % eval_every == 0,
        telemetry=telemetry, telemetry_extra=telemetry_extra)
    if return_state:
        return p, rounds_used, history, st
    return p, rounds_used, history


def run_fl_until(loss_fn, stacked_params, sample_batches, engine,
                 lr: float, *, target_fn: Callable, max_rounds: int,
                 generator, eval_every: int = 1, codec=None,
                 return_state: bool = False, telemetry=None,
                 telemetry_extra=None):
    """Drive decentralized FL rounds until ``target_fn(stacked_params)``
    (which returns ``(reached: bool, metric)``) is reached or
    ``max_rounds`` ran — how the paper's t_i is measured.

    ``sample_batches(generator, t) -> stacked batches`` (leading agent
    axis K, then the local-step axis); ``generator`` also drives the
    stochastic rounding of a quantizing codec (``None``: round to
    nearest). ``engine``: a :class:`ConsensusEngine`, a σ matrix or a
    Topology (the latter two are wrapped, with ``codec`` applied); the
    codec's error-feedback residuals thread across rounds, and an async
    engine's :class:`AsyncState` too.

    Returns ``(params, rounds_used, metric_history)``, plus the final
    codec state with ``return_state=True``. Host-loop driver: one
    device→host read per ROUND. :func:`run_fl_until_scan` reads once per
    chunk and gives the same bits."""
    return _run_fl_chunked(
        loss_fn, stacked_params, sample_batches, engine, lr,
        target_fn=target_fn, max_rounds=max_rounds, generator=generator,
        eval_every=eval_every, codec=codec, chunk=1,
        return_state=return_state, telemetry=telemetry,
        telemetry_extra=telemetry_extra)


def run_fl_until_scan(loss_fn, stacked_params, sample_batches, engine,
                      lr: float, *, target_fn: Callable, max_rounds: int,
                      generator, eval_every: int = 1, codec=None,
                      chunk: int = 32, return_state: bool = False,
                      telemetry=None, telemetry_extra=None):
    """:func:`run_fl_until` with ONE device→host read per ``chunk``
    rounds instead of one per round (see the module docstring).

    Exactness contract: params, ``rounds_used``, history and codec state
    are bit-identical to :func:`run_fl_until` — the rounds run the same
    ops in the same order, and the rounds of a chunk after the hit are
    discarded with ``torch.where`` on the device-side live flag.
    ``max_rounds`` need not be a multiple of ``chunk``. A chunk that ends
    after the hit draws its discarded rounds from ``generator`` too, so
    the caller's generator advances further than with ``chunk=1``.

    ``telemetry`` (:class:`repro_torch.telemetry.Telemetry`) records one
    ``fl`` row per round — Eq.-(11) joules by link class, wire bits,
    surviving-edge counts, disagreement, reached flags — in the chunk's
    read (buffered) or additionally read and emitted as each round ends
    (streaming, one read per round). ``telemetry_extra``: a dict merged
    into every event (e.g. ``{"task_id": i}``)."""
    return _run_fl_chunked(
        loss_fn, stacked_params, sample_batches, engine, lr,
        target_fn=target_fn, max_rounds=max_rounds, generator=generator,
        eval_every=eval_every, codec=codec, chunk=chunk,
        return_state=return_state, telemetry=telemetry,
        telemetry_extra=telemetry_extra)
