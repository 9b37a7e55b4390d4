"""Decentralized per-cluster federated learning (paper Sect. II-B): each
round every agent takes its local SGD steps, then one Eq.-(6) consensus
round through the engine. Lockstep rounds on static graphs."""
from __future__ import annotations

import torch
from torch.func import grad, vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core.engine import ConsensusEngine


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
                           generator=None):
    """One FL round: per-agent local SGD (``torch.func.vmap`` over the
    leading agent axis K), then one consensus step.

    ``engine``: a :class:`ConsensusEngine`, or a (K, K) σ / Topology that
    is wrapped into one (``codec`` then applies to it). With a codec the
    result is ``(params, codec_state)``, without one the params.
    ``generator`` enables stochastic rounding."""
    engine = ConsensusEngine.wrap(engine, codec=codec)
    new_params = vmap(lambda p, b: local_steps(loss_fn, p, b, lr))(
        stacked_params, stacked_batches)
    params, state = engine.step(new_params, codec_state, generator)
    if engine.codec is None:
        return params
    return params, state
