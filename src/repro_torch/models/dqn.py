"""The paper's Q-network: the DeepMind DQN shape (Mnih et al. 2015) —
5 trainable layers — on the 40-landmark gridworld's one-hot state.

Parameters keep the JAX package's names and layout: ``fc{i}.w`` is
(in, out) and ``fc{i}.b`` is (out,), so ``x @ w + b`` per layer, ReLU
between layers. Functions take a flat ``{name: tensor}`` dict and run the
:class:`QNetwork` module through ``torch.func.functional_call``.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.models import layers as L

STATE_DIM = 40      # 40 landmark positions (one-hot)
NUM_ACTIONS = 4     # F, B, L, R


def layer_dims(cfg):
    return [STATE_DIM] + [cfg.d_model] * (cfg.num_layers - 1) + [NUM_ACTIONS]


class Dense(nn.Module):
    """x @ w + b with w stored (in, out), as in the JAX package."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    def forward(self, x):
        return x @ self.w + self.b


class QNetwork(nn.Module):
    """state (B, 40) → q-values (B, 4)."""

    def __init__(self, cfg):
        super().__init__()
        dims = layer_dims(cfg)
        self.num_layers = cfg.num_layers
        for i in range(cfg.num_layers):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1]))

    def forward(self, state):
        x = state.to(torch.float32)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


@functools.lru_cache(maxsize=None)
def _template(cfg) -> QNetwork:
    """A weightless (meta-device) module whose parameters the functional
    calls replace."""
    with torch.device("meta"):
        return QNetwork(cfg)


def init(cfg, *, generator=None, device="cuda"):
    """Random params: truncated-normal fan-in weights, zero biases."""
    dims = layer_dims(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    params = {}
    for i in range(cfg.num_layers):
        params[f"fc{i}.w"] = L.dense_init((dims[i], dims[i + 1]),
                                          generator=generator, dtype=dtype,
                                          device=device)
        params[f"fc{i}.b"] = torch.zeros(dims[i + 1], dtype=dtype,
                                         device=device)
    return params


def forward(params, cfg, state):
    """state (B, 40) one-hot → q-values (B, 4)."""
    return functional_call(_template(cfg), params, (state,))
