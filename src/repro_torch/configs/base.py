"""Architecture config and registry: the port's own copy of the JAX
package's ``configs/base.py``, holding the fields the ported models read
(the DQN and the RecurrentGemma hybrid). The JAX config's MoE, xLSTM,
encoder-decoder, remat and layer-type fields wait for the slices that
port those families."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrence settings."""

    lru_width: int = 0               # 0 -> d_model
    conv1d_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Frozen, so it can key caches.

    ``family`` selects the model constructor (:func:`repro_torch.models.
    api.get_model`): ``dqn`` and ``hybrid`` (rg-lru) are ported."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: int = 0                # 0 -> d_model // num_heads
    sliding_window: int = 0          # 0 -> full attention; else SWA window
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"                # mlp activation: silu | gelu | relu
    mlp_kind: str = "gated"          # gated (llama) | plain (whisper/gpt)
    use_qk_norm: bool = False
    logit_softcap: float = 0.0

    rglru: Optional[RGLRUConfig] = None

    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced(cfg: ArchConfig, *, num_layers: int = 2, d_model: int = 256,
            vocab: int = 512) -> ArchConfig:
    """A smoke-test-sized variant of the same family (CPU-runnable): the
    JAX package's ``reduced`` on the fields the port has."""
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    changes = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=max(2 * d_model, 64) if cfg.d_ff else 0,
        vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        dtype="float32",
    )
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, lru_width=0)
    return dataclasses.replace(cfg, **changes)
