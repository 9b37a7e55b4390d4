"""Model-Agnostic Meta-Learning — paper Eqs. (2)–(5).

  task-specific training (Eq. 3):  φ_{t,τ_i} = W_t − μ Σ_k ∇_W L_k(W_t | E^(a))
  meta-model update (Eq. 4):       W_{t+1} = W_t − η Σ_i Σ_k ∇_W L_k[φ | E^(b)]
  where (Eq. 5) ∇_W L = J_W[φ] · ∇_φ L.

``first_order=True`` applies the paper's J ≈ I approximation (β = 1);
``False`` differentiates through the inner SGD (``torch.func.grad`` of a
function that itself takes ``torch.func.grad``). Tasks are batched with
``torch.func.vmap``. ``loss_fn(params, batch) -> scalar`` and params are
a ``{name: tensor}`` dict.

Two drivers run ``rounds`` meta rounds: :func:`maml_train` reads the
meta-loss back every round and calls a host ``callback``;
:func:`maml_train_scan` reads the losses once per ``chunk`` rounds. Both
replay the same cached round program (:func:`maml_round_program`: on the
card one CUDA graph a round, the params updated in place), so their
params and histories agree bit for bit.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad, grad_and_value, vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import scanloop


def inner_adapt(loss_fn: Callable, params, batch, lr: float,
                steps: int = 1):
    """Eq. (3): ``steps`` SGD steps on one task's support data.

    ``batch`` may carry a leading steps axis (one mini-batch per step) or
    be a single batch reused every step. Differentiable."""

    def one_step(p, b):
        g = grad(loss_fn)(p, b)
        return {k: w - lr * g[k].to(w.dtype) for k, w in p.items()}

    if steps == 1:
        return one_step(params, batch)
    leaves = tree_leaves(batch)
    has_step_axis = bool(leaves) and all(
        tuple(x.shape[:1]) == (steps,) for x in leaves)
    for i in range(steps):
        b = tree_map(lambda x: x[i], batch) if has_step_axis else batch
        params = one_step(params, b)
    return params


def maml_meta_step(loss_fn: Callable, meta_params, support, query, *,
                   inner_lr: float, outer_lr: float,
                   inner_steps: int = 1, first_order: bool = True):
    """One MAML round over Q tasks (``support``/``query`` carry a leading
    task axis Q). Returns ``(new_meta_params, metrics)``."""

    def task_meta_loss(p, sup, qry):
        phi = inner_adapt(loss_fn, p, sup, inner_lr, inner_steps)
        if first_order:
            # J ≈ I: gradients reach W through φ's value only
            phi = {k: (phi[k] - p[k]).detach() + p[k] for k in p}
        return loss_fn(phi, qry)

    def mean_meta_loss(p):
        losses = vmap(lambda s, q: task_meta_loss(p, s, q))(support, query)
        return losses.mean(), losses

    g, (mloss, task_losses) = grad_and_value(
        mean_meta_loss, has_aux=True)(meta_params)
    new_params = {
        k: (w.to(torch.float32) - outer_lr * g[k].to(torch.float32)
            ).to(w.dtype)
        for k, w in meta_params.items()}
    metrics = {"meta_loss": mloss, "task_losses": task_losses,
               "meta_grad_norm": torch.sqrt(sum(
                   x.to(torch.float32).square().sum() for x in g.values()))}
    return new_params, metrics


def _default_generator(generator, params):
    """``generator``, or one seeded 0 on the params' device."""
    if generator is not None:
        return generator
    device = next(iter(params.values())).device
    return torch.Generator(device=device).manual_seed(0)


def maml_round_program(step: Callable, *, host_fns=(),
                       streaming: bool = False):
    """One meta round as a :func:`repro_torch.core.scanloop.donating_graph`
    program: ``maml_round(params, t, generator, batches) -> ((params,),
    {"row": (meta_loss, meta_grad_norm), "metrics": metrics})`` with the
    params donated. ``step(t, params, generator, batches) -> (params,
    metrics)`` runs meta round ``t`` (metrics as :func:`maml_meta_step`
    gives them); ``batches`` is the host sampler's ``(support, query)``,
    else ``None``."""

    def maml_round(params, t, generator, batches):
        new, m = step(t, params, generator, batches)
        return (new,), {"row": torch.stack([m["meta_loss"],
                                            m["meta_grad_norm"]]),
                        "metrics": m}

    prog = scanloop.donating_graph(maml_round, donate_argnums=(0,),
                                   name="maml_chunk")
    prog.record.host_fns = tuple(host_fns)
    prog.record.streaming = bool(streaming)
    return prog


def _maml_program(loss_fn, sample_tasks, meta_params, generator, *,
                  inner_lr, outer_lr, inner_steps, first_order,
                  telemetry=None):
    """``(program, host_sampler)`` of :func:`maml_train` and
    :func:`maml_train_scan`: the cached program on the JAX package's key
    (the loss and sampler by identity and the baked hyper-parameters; the
    params' shapes pick a variant inside it), probing ``sample_tasks`` on
    a miss. A sampler that fails the probe runs on the host each round
    (returned as ``host_sampler``) and its program is never cached; nor
    is a streaming-telemetry program. Buffered telemetry shares the
    telemetry-off program: the metrics already come out of every round."""
    streaming = telemetry is not None and telemetry.streaming
    key = ("maml_chunk", loss_fn, sample_tasks, float(inner_lr),
           float(outer_lr), int(inner_steps), bool(first_order))
    if not streaming:
        cached = scanloop.get_cached_program(key)
        if cached is not None:
            return cached, None            # hit: skip the probe
    device = next(iter(meta_params.values())).device
    _, traced = scanloop.traceable(
        sample_tasks, generator,
        torch.zeros((), dtype=torch.int64, device=device),
        name="sample_tasks")

    def step(t, params, generator, batches):
        support, query = (sample_tasks(generator, t) if batches is None
                          else batches)
        return maml_meta_step(
            loss_fn, params, support, query, inner_lr=inner_lr,
            outer_lr=outer_lr, inner_steps=inner_steps,
            first_order=first_order)

    def build():
        return maml_round_program(
            step, host_fns=() if traced else ("sample_tasks",),
            streaming=streaming)

    if streaming or not traced:
        return build(), None if traced else sample_tasks
    return scanloop.cached_program(key, build), None


def maml_train(loss_fn: Callable, meta_params, sample_tasks: Callable,
               *, rounds: int, inner_lr: float, outer_lr: float,
               inner_steps: int = 1, first_order: bool = True,
               generator=None, callback: Optional[Callable] = None):
    """Run ``rounds`` MAML rounds. ``sample_tasks(generator, round) ->
    (support, query)`` with a leading task axis. Host-loop driver: one
    device→host read of the meta-loss per round, and the only driver
    with a per-round host ``callback(t, params, metrics)`` (given copies
    that outlive the next round). It replays the same cached round
    program as :func:`maml_train_scan`. Returns ``(meta_params,
    history)``."""
    generator = _default_generator(generator, meta_params)
    program, sampler = _maml_program(
        loss_fn, sample_tasks, meta_params, generator, inner_lr=inner_lr,
        outer_lr=outer_lr, inner_steps=inner_steps, first_order=first_order)
    return run_meta_rounds(program, meta_params, rounds=rounds, chunk=1,
                           generator=generator, sampler=sampler,
                           callback=callback)


def maml_train_scan(loss_fn: Callable, meta_params, sample_tasks: Callable,
                    *, rounds: int, inner_lr: float, outer_lr: float,
                    inner_steps: int = 1, first_order: bool = True,
                    generator=None, chunk: int = 32, telemetry=None):
    """:func:`maml_train` with the meta-loss history read once per
    ``chunk`` rounds (one device→host copy of the chunk's losses and
    meta-gradient norms) instead of once per round; params and history
    are the same bits. ``rounds`` need not be a multiple of ``chunk``.

    ``telemetry`` records one ``maml`` event per round (``meta_loss``,
    ``meta_grad_norm``) from the chunk's read; in streaming mode each
    round is also read and emitted as it ends (one read per round)."""
    generator = _default_generator(generator, meta_params)
    if rounds <= 0:
        return meta_params, []
    program, sampler = _maml_program(
        loss_fn, sample_tasks, meta_params, generator, inner_lr=inner_lr,
        outer_lr=outer_lr, inner_steps=inner_steps, first_order=first_order,
        telemetry=telemetry)
    return run_meta_rounds(program, meta_params, rounds=rounds, chunk=chunk,
                           generator=generator, sampler=sampler,
                           telemetry=telemetry)


def run_meta_rounds(program, meta_params, *, rounds: int, chunk: int,
                    generator=None, sampler: Optional[Callable] = None,
                    telemetry=None, callback: Optional[Callable] = None):
    """The chunked loop of :func:`maml_train_scan`, :func:`maml_train`
    and the case study's meta-training: meta round ``t`` is one replay of
    ``program`` (:func:`maml_round_program`), after ``sampler(generator,
    t)`` on the host when the sampler failed the capture probe. The
    chunk's meta-losses and meta-gradient norms are read in one
    device→host copy (with ``telemetry``, recorded as ``maml`` events;
    streaming also reads and emits each round as it ends).
    ``callback(t, params, metrics)`` is called after every round. Returns
    ``(meta_params, history)``."""
    if rounds <= 0:
        return meta_params, []
    params = scanloop.own(meta_params)
    device = next(iter(params.values())).device
    chunk = max(1, min(int(chunk), rounds))
    stream = (telemetry.maml_stream_cb()
              if telemetry is not None and telemetry.streaming else None)
    history = []
    for start in range(0, rounds, chunk):
        n = min(chunk, rounds - start)
        ts = torch.arange(start, start + n, device=device)
        out = None
        for i in range(n):
            t = start + i
            batches = None if sampler is None else sampler(generator, t)
            (params,), ys = program(params, ts[i], generator, batches)
            if out is None:
                out = torch.empty((n, 2), dtype=ys["row"].dtype,
                                  device=device)
            out[i].copy_(ys["row"])
            if stream is not None:
                stream(t, out[i, 0], out[i, 1])
            if callback is not None:
                callback(t, scanloop.own(params),
                         scanloop.own(ys["metrics"]))
        host = scanloop.to_host(out)                        # one read
        if telemetry is not None:
            telemetry.record_maml_rounds(
                {"meta_loss": host[:, 0], "meta_grad_norm": host[:, 1]},
                start)
        history.extend(float(x) for x in host[:, 0])
    return scanloop.own(params), history
