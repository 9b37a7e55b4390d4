"""Architecture config and registry: the port's own copy, holding only the
fields the DQN reads (the JAX package's config also carries the LM zoo's
fields, which no part of the port reads yet)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Frozen, so it can key caches."""

    name: str
    num_layers: int
    d_model: int
    param_dtype: str = "float32"


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
