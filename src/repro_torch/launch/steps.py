"""Step builders of the serving path: the port's ``make_prefill_step`` and
``make_decode_step`` (the JAX package's ``launch/steps.py``). Both run
without autograd."""
from __future__ import annotations

import torch

from repro_torch.models.api import get_model


def make_prefill_step(cfg):
    """(params, caches, batch{tokens}) -> (last-position logits (B, 1, V),
    caches). Only the last position is unembedded, which gives the numbers
    of slicing the full logits without the (B, S, V) tensor."""
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, caches, batch):
        logits, caches, _ = model.forward(params, cfg, batch["tokens"],
                                          caches=caches, cache_index=0,
                                          last_only=True)
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
