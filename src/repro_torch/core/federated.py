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
same round without a vote; rounds the grid skips issue no collective.
"""
from __future__ import annotations

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


def run_chunked_rounds(engine, round_fn, params, *, max_rounds: int,
                       chunk: int, telemetry=None, telemetry_extra=None,
                       keep_delivered: bool = False):
    """The chunked loop every FL driver runs (:func:`run_fl_until`,
    :func:`run_fl_until_scan` and the case study's adaptation).

    ``round_fn(t, params, state, survival, active) -> (new_params,
    new_state, hit, metric, evaluated)`` computes round ``t`` from the
    carried params and codec state (``None`` without a stateful codec),
    given the round's plan-shaped link survival or staleness weights and,
    on async engines, the (K,) activity. ``hit`` is a 0-d bool tensor,
    ``metric`` a 0-d tensor and ``evaluated`` a Python bool: the history
    keeps the metrics of the live rounds that evaluated.

    Per chunk: the engine's draws in one vectorised call each, then ONE
    device→host read of the reached flags, the evaluated mask, the
    metrics, the delivered lanes (``keep_delivered``) and the telemetry
    rows, in one ``torch.cat``; the loop ends after the chunk in which a
    round hit. Rounds after the hit are computed and discarded with
    ``torch.where`` on the device-side live flag (params, codec state,
    :class:`AsyncState`; their rows become :meth:`RoundRecorder.frozen_row`),
    so every chunk size gives the same bits. Rounds past ``max_rounds``
    are never computed: the last chunk is cut short instead.

    Returns ``(params, state, rounds_used, history, delivered)``;
    ``delivered`` is a host bool array ``(rounds_used,) + lane shape`` of
    the wires the device delivered when ``keep_delivered`` is set and
    links fade or agents sleep, else ``None``."""
    device = next(iter(params.values())).device
    st = engine.init_state(params)
    is_async = engine.agents is not None
    fading = engine.graph.kind != "static"
    keep = keep_delivered and (is_async or fading)
    ast = engine.init_async_state(device=device) if is_async else None
    recorder = (telemetry.recorder_for(engine) if telemetry is not None
                else None)
    stream = (telemetry.stream_cb(recorder, "fl", telemetry_extra)
              if telemetry is not None and telemetry.streaming else None)
    chunk = max(1, min(int(chunk), max_rounds))
    f64 = torch.float64
    reached = torch.zeros((), dtype=torch.bool, device=device)
    history, delivered, rounds_used = [], [], max_rounds
    for start in range(0, max_rounds, chunk):
        n = min(chunk, max_rounds - start)
        # the chunk's draws, one vectorised call each on the device
        ts = torch.arange(start, start + n, device=device)
        links = engine.round_survival(ts) if fading else None
        acts = engine.availability(ts) if is_async else None
        flags, delivs, rows = [], [], []
        for i in range(n):
            t = start + i
            link = None if links is None else links[i]
            if is_async:
                # one availability draw per round, shared between the
                # staleness weights, the per-agent freeze and the row
                # (which bills only DELIVERED wires)
                ar = engine.async_round(t, ast.age, act=acts[i], link=link)
                sv, act, deliv = ar.weights, ar.act, ar.delivered
            else:
                sv, act, deliv = link, None, link
            new, new_st, hit, metric, evaluated = round_fn(t, params, st,
                                                           sv, act)
            live = ~reached
            if recorder is not None:
                row = recorder.live_row(live, recorder.row(
                    new, deliv, metric=metric, reached=hit, live=True,
                    active=act, age=ar.age if is_async else None))
                if stream is not None:
                    stream(t, row)
                rows.append(row)
            params = where_active(live, new, params)
            if new_st is not None:
                st = where_active(live, new_st, st)
            if is_async:
                ast = AsyncState(
                    torch.where(live, ast.clock + act.to(ast.clock.dtype),
                                ast.clock),
                    torch.where(live, ar.age, ast.age))
            reached = reached | (live & hit)
            # a discarded round reports the carried reached flag (True),
            # is not evaluated and has metric 0, as the JAX freeze does
            flags.append(torch.stack([
                reached.to(f64), (live & evaluated).to(f64),
                torch.where(live, metric.to(f64), 0.0)]))
            if keep:
                delivs.append(deliv.flatten().to(f64))
        cols = [torch.stack(flags)]
        if keep:
            cols.append(torch.stack(delivs))
        if recorder is not None:
            cols.append(recorder.pack(rows))
        host = scanloop.to_host(torch.cat(cols, 1))          # one read
        lanes = deliv.numel() if keep else 0
        if keep:
            lane_shape = tuple(deliv.shape)
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
    delivered = (np.stack(delivered[:rounds_used]).reshape(
        (rounds_used,) + lane_shape) if keep else None)
    return params, st, rounds_used, history, delivered


def _run_fl_chunked(loss_fn, stacked_params, sample_batches, engine, lr, *,
                    target_fn, max_rounds, generator, eval_every, codec,
                    chunk, return_state, telemetry=None,
                    telemetry_extra=None):
    """:func:`run_chunked_rounds` with the round of Eq. (6):
    ``sample_batches``, :func:`decentralized_fl_round` and ``target_fn``
    on the ``eval_every`` grid."""
    engine = ConsensusEngine.wrap(engine, codec=codec)
    has_codec = engine.codec is not None
    device = next(iter(stacked_params.values())).device
    meshed = engine.local_rows is not None

    def fl_round(t, p, st, sv, act):
        out = decentralized_fl_round(
            loss_fn, p, sample_batches(generator, t), engine, lr,
            codec_state=st, generator=generator if has_codec else None,
            survival=sv, active=act)
        new, new_st = out if has_codec else (out, None)
        if eval_every == 1 or (t + 1) % eval_every == 0:
            # target_fn sees the whole population, on a mesh too
            r, metric = target_fn(consensus.gather_population(
                new, engine.mesh, engine.plan.axis_name) if meshed else new)
            return (new, new_st,
                    torch.as_tensor(r, device=device).to(torch.bool),
                    torch.as_tensor(metric, device=device).reshape(()),
                    True)
        # off-grid rounds skip the evaluation entirely
        return (new, new_st, torch.zeros((), dtype=torch.bool, device=device),
                torch.zeros((), dtype=torch.float32, device=device), False)

    p, st, rounds_used, history, _ = run_chunked_rounds(
        engine, fl_round, stacked_params, max_rounds=max_rounds,
        chunk=chunk, telemetry=telemetry, telemetry_extra=telemetry_extra)
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
