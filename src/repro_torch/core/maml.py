"""Model-Agnostic Meta-Learning — paper Eqs. (2)–(5).

  task-specific training (Eq. 3):  φ_{t,τ_i} = W_t − μ Σ_k ∇_W L_k(W_t | E^(a))
  meta-model update (Eq. 4):       W_{t+1} = W_t − η Σ_i Σ_k ∇_W L_k[φ | E^(b)]
  where (Eq. 5) ∇_W L = J_W[φ] · ∇_φ L.

``first_order=True`` applies the paper's J ≈ I approximation (β = 1);
``False`` differentiates through the inner SGD (``torch.func.grad`` of a
function that itself takes ``torch.func.grad``). Tasks are batched with
``torch.func.vmap``. ``loss_fn(params, batch) -> scalar`` and params are
a ``{name: tensor}`` dict.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, grad_and_value, vmap
from torch.utils._pytree import tree_leaves, tree_map


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
