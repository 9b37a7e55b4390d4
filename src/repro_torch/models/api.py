"""Family dispatch: the port's counterpart of the JAX package's
``models/api.py::get_model``.

Every family exposes ``init(cfg, *, generator, device)`` and
``forward(params, cfg, ...)``; decoder families also ``init_cache(cfg,
batch, seq_len, *, device)`` and ``cast_for_serving(params, cfg)``.
"""
from __future__ import annotations

from types import SimpleNamespace


def get_model(cfg) -> SimpleNamespace:
    if cfg.family == "hybrid":
        from repro_torch.models import rglru as m
        return SimpleNamespace(init=m.init, forward=m.forward,
                               init_cache=m.init_cache,
                               cast_for_serving=m.cast_for_serving)
    if cfg.family == "dqn":
        from repro_torch.models import dqn as m
        return SimpleNamespace(init=m.init, forward=m.forward,
                               init_cache=None)
    raise ValueError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: of the LM "
        "families the port runs only 'hybrid' (recurrentgemma-9b) so far, "
        "besides the case study's 'dqn'")
