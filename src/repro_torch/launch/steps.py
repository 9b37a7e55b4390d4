"""Step builders: the port's ``make_train_step``, ``make_prefill_step``
and ``make_decode_step`` (the JAX package's ``launch/steps.py``). The
serving steps run without autograd."""
from __future__ import annotations

import torch

from repro_torch.models.api import get_model, lm_loss
from repro_torch.optim import adam, clip_scale


def value_and_grad(loss, params, *args):
    """(loss, {name: gradient}) of ``loss(params, *args)`` at a
    ``{name: tensor}`` dict, by ``torch.autograd`` (so a ``cfg.remat``
    forward recomputes its blocks in the backward)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        val = loss(leaves, *args)
        grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


def make_train_step(cfg, *, lr: float = 3e-4, clip_norm: float = 1.0):
    """(params, opt_state, batch{tokens, labels, frames (encdec)}) ->
    (params, opt_state, {"loss", "grad_norm"}): Adam on the gradient
    clipped to a global norm of ``clip_norm``. ``params`` is the model's
    ``stack_params`` dict. Returns ``(train_step, opt)``.

    The step consumes ``params`` and ``opt_state`` through the
    optimizer's ``apply`` (:mod:`repro_torch.optim.optimizers`), so its
    peak is about the f32 params, Adam's two moments and the gradient (4×
    the params), not old and new of each (8×). The numbers are those of
    clipping the whole gradient and updating every leaf at once."""
    model = get_model(cfg)
    opt = adam(lr)

    def loss(params, batch):
        return lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       embeddings=batch.get("frames"), model=model)

    def train_step(params, opt_state, batch):
        l, g = value_and_grad(loss, params, batch)
        scale, gnorm = clip_scale(g, clip_norm)
        params, opt_state = opt.apply(g, opt_state, params, scale)
        return params, opt_state, {"loss": l, "grad_norm": gnorm}

    return train_step, opt


def make_prefill_step(cfg):
    """(params, caches, batch{tokens, frames (encdec)}) -> (last-position
    logits (B, 1, V), caches). Only the last position is unembedded, which
    gives the numbers of slicing the full logits without the (B, S, V)
    tensor. The encoder-decoder's ``frames`` run its encoder and fill the
    cross caches."""
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, caches, batch):
        frames = batch.get("frames")
        kw = {} if frames is None else {"embeddings": frames}
        logits, caches, _ = model.forward(params, cfg, batch["tokens"],
                                          caches=caches, cache_index=0,
                                          last_only=True, **kw)
        return logits, caches

    return prefill_step


def make_decode_step(cfg):
    """(params, caches, batch{tokens (B, 1), cache_index}) -> (greedy next
    token (B, 1) int32, caches)."""
    model = get_model(cfg)

    @torch.no_grad()
    def decode_step(params, caches, batch):
        logits, caches, _ = model.forward(params, cfg, batch["tokens"],
                                          caches=caches,
                                          cache_index=batch["cache_index"])
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], caches

    return decode_step
