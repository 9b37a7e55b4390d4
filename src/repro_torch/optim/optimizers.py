"""Functional optimizers over ``{name: tensor}`` dicts: the port of the JAX
package's ``optim/optimizers.py`` (optax-style ``(init, update)`` pairs).

An optimizer is a SimpleNamespace(init, update)::

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Updates are NEGATIVE deltas already scaled by the learning rate, in f32;
the state is f32 with an int32 ``step``, and Adam's bias corrections are
``1 - b ** step`` in f32, as in the JAX package.

``params, state = opt.apply(grads, state, params, scale)`` gives the
numbers of ``update`` then :func:`apply_updates` on ``grads`` times
``scale`` (a () tensor, as :func:`clip_scale` gives; None for 1). It
consumes its inputs as a donated buffer is: it makes the new params and
state one leaf at a time, popping that leaf's gradient, param and
per-leaf state as it goes, so it holds each leaf about once, not old
and new of every leaf. ``grads``, ``params`` and the state's per-leaf
dicts are left empty. With ``in_place=True`` it writes each new leaf into
the old one's tensor (an exact copy, the same bits) and returns those
tensors: a step whose params and state are a captured program's donated
buffers then updates them with no second copy of the model.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Union

import torch

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]
_F32 = torch.float32


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in tree.values()))


def clip_scale(tree, max_norm: float, *, norm=None):
    """(the factor that scales ``tree`` to a global norm of at most
    ``max_norm``, the norm): leaf x becomes ``x * scale.to(x.dtype)``.
    ``norm``: the norm when the caller has it (a tensor-parallel shard's
    gradient, whose norm is the whole model's)."""
    n = global_norm(tree) if norm is None else norm
    return torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0), n


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm)."""
    scale, n = clip_scale(tree, max_norm)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, n


def _applied(p, u):
    return (p.to(_F32) + u.to(_F32)).to(p.dtype)


def apply_updates(params, updates):
    return {k: _applied(p, updates[k]) for k, p in params.items()}


def _scaled(g, scale):
    return g if scale is None else g * scale.to(g.dtype)


def _zeros_f32(params):
    return {k: torch.zeros_like(p, dtype=_F32) for k, p in params.items()}


def _kept(old, new, in_place: bool):
    """``new``, or with ``in_place`` ``old`` holding ``new``'s values."""
    return old.copy_(new) if in_place else new


def _step0(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: Schedule, momentum: float = 0.0):
    """Plain SGD — the paper's device-side optimizer (Eq. 3 inner steps)."""

    def init(params):
        st = {"step": _step0(params)}
        if momentum:
            st["mom"] = _zeros_f32(params)
        return st

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mom = {k: momentum * m + grads[k].to(_F32)
                   for k, m in state["mom"].items()}
            return ({k: -lr_t * m for k, m in mom.items()},
                    {"step": step, "mom": mom})
        return ({k: -lr_t * g.to(_F32) for k, g in grads.items()},
                {"step": step})

    def apply(grads, state, params, scale=None, in_place=False):
        step = _kept(state["step"], state["step"] + 1, in_place)
        lr_t = _lr_at(lr, step)
        out, mom = {}, {}
        for k in list(params):
            g = _scaled(grads.pop(k), scale).to(_F32)
            if momentum:
                m = state["mom"].pop(k)
                g = mom[k] = _kept(m, momentum * m + g, in_place)
            u = -lr_t * g
            del g                    # freed before the new param is made
            p = params.pop(k)
            out[k] = _kept(p, _applied(p, u), in_place)
        return out, ({"step": step, "mom": mom} if momentum
                     else {"step": step})

    return SimpleNamespace(init=init, update=update, apply=apply)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0):
    def init(params):
        return {"step": _step0(params), "mu": _zeros_f32(params),
                "nu": _zeros_f32(params)}

    def scalars(state):
        """The step, its lr and the two bias corrections: once a step."""
        step = state["step"] + 1
        sf = step.to(_F32)
        # fills on the device, not host copies: the step runs inside a
        # captured program
        bc1 = 1 - torch.pow(torch.full((), b1, dtype=_F32, device=sf.device),
                            sf)
        bc2 = 1 - torch.pow(torch.full((), b2, dtype=_F32, device=sf.device),
                            sf)
        return step, _lr_at(lr, step), bc1, bc2

    def leaf(g, m, v, p, lr_t, bc1, bc2):
        """(update, mu, nu) of one leaf."""
        g = g.to(_F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        del g                        # freed before the update's temporaries
        u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u - lr_t * weight_decay * p.to(_F32)
        return u, m, v

    def update(grads, state, params=None):
        step, *sc = scalars(state)
        updates, mu, nu = {}, {}, {}
        for k, m in state["mu"].items():
            updates[k], mu[k], nu[k] = leaf(
                grads[k], m, state["nu"][k],
                None if params is None else params[k], *sc)
        return updates, {"step": step, "mu": mu, "nu": nu}

    def apply(grads, state, params, scale=None, in_place=False):
        step, *sc = scalars(state)
        step = _kept(state["step"], step, in_place)
        out, mu, nu = {}, {}, {}
        for k in list(params):
            m0, v0 = state["mu"].pop(k), state["nu"].pop(k)
            u, m, v = leaf(_scaled(grads.pop(k), scale), m0, v0, params[k],
                           *sc)
            mu[k], nu[k] = _kept(m0, m, in_place), _kept(v0, v, in_place)
            del m, v
            p = params.pop(k)
            out[k] = _kept(p, _applied(p, u), in_place)
        return out, {"step": step, "mu": mu, "nu": nu}

    return SimpleNamespace(init=init, update=update, apply=apply)


def adamw(lr: Schedule, weight_decay: float = 0.01, **kw):
    return adam(lr, weight_decay=weight_decay, **kw)
