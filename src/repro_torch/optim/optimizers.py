"""Functional optimizers over ``{name: tensor}`` dicts: the port of the JAX
package's ``optim/optimizers.py`` (optax-style ``(init, update)`` pairs).

An optimizer is a SimpleNamespace(init, update)::

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Updates are NEGATIVE deltas already scaled by the learning rate, in f32;
the state is f32 with an int32 ``step``, and Adam's bias corrections are
``1 - b ** step`` in f32, as in the JAX package.
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


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return {k: x * scale.to(x.dtype) for k, x in tree.items()}, n


def apply_updates(params, updates):
    return {k: (p.to(_F32) + updates[k].to(_F32)).to(p.dtype)
            for k, p in params.items()}


def _zeros_f32(params):
    return {k: torch.zeros_like(p, dtype=_F32) for k, p in params.items()}


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

    return SimpleNamespace(init=init, update=update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0):
    def init(params):
        return {"step": _step0(params), "mu": _zeros_f32(params),
                "nu": _zeros_f32(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        mu = {k: b1 * m + (1 - b1) * grads[k].to(_F32)
              for k, m in state["mu"].items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].to(_F32))
              for k, v in state["nu"].items()}
        sf = step.to(_F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=_F32, device=sf.device),
                            sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=_F32, device=sf.device),
                            sf)
        updates = {}
        for k in mu:
            u = -lr_t * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * params[k].to(_F32)
            updates[k] = u
        return updates, {"step": step, "mu": mu, "nu": nu}

    return SimpleNamespace(init=init, update=update)


def adamw(lr: Schedule, weight_decay: float = 0.01, **kw):
    return adam(lr, weight_decay=weight_decay, **kw)
