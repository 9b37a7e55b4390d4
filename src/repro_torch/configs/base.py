"""Architecture config and registry: the port's own copy of the JAX
package's ``configs/base.py``, holding the fields the ported models read
(the DQN, the RecurrentGemma hybrid, xLSTM, the whisper encoder-decoder
and the decoder-only transformer family: dense, MoE and the VLM
backbone). The JAX config's ``remat_policy`` (its ``"dots"`` policy
saves matmul outputs; the port recomputes whole blocks),
``unroll_layers`` (a cost-analysis probe of XLA's scans) and
``attention_types`` (read by no model) are left out."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for a block's MLP."""

    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0      # qwen2-moe style always-on experts
    router_aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25    # used by capacity-based dispatch
    shared_expert_d_ff: int = 0      # d_ff of the shared expert (0 -> same as experts)


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrence settings."""

    lru_width: int = 0               # 0 -> d_model
    conv1d_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block-stack settings (arXiv:2405.04517)."""

    slstm_at: Tuple[int, ...] = ()   # layer indices using sLSTM; rest mLSTM
    mlstm_proj_factor: float = 2.0   # up-projection factor for mLSTM blocks
    slstm_proj_factor: float = 4.0 / 3.0
    conv1d_width: int = 4


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper) settings. The frontend is a stub
    (:mod:`repro_torch.models.frontend`)."""

    num_encoder_layers: int = 32
    encoder_seq_len: int = 1500      # 30 s audio -> 1500 frames after conv stub
    max_decoder_ctx: int = 448


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Frozen, so it can key caches.

    ``family`` selects the model constructor (:func:`repro_torch.models.
    api.get_model`): ``dense``, ``moe`` and ``vlm`` (a dense decoder over
    an early-fusion token stream) are the transformer, ``hybrid`` is
    rg-lru, ``ssm`` xLSTM, ``encdec`` whisper, ``dqn`` the case study's
    Q-network."""

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
    tie_embeddings: bool = False
    act: str = "silu"                # mlp activation: silu | gelu | relu
    mlp_kind: str = "gated"          # gated (llama) | plain (whisper/gpt)
    use_qk_norm: bool = False
    logit_softcap: float = 0.0

    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encdec: Optional[EncDecConfig] = None

    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True               # recompute each block in the backward

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve ~500k contexts (O(T) or O(w*T) attention)?"""
        return self.family in ("hybrid", "ssm") or self.sliding_window > 0

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder_only"

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + norms), the JAX
        package's formula. Like the JAX one, it leaves out the shared
        expert's gate (d per MoE layer) and the q/k norms (2·head_dim per
        layer); its xLSTM term is a rough one, and for the
        encoder-decoder it counts an unembedding the model ties to
        ``embed``, so neither matches the model's count."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.head_dim_
        emb = V * d * (1 if self.tie_embeddings else 2)
        att = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        n_mlp_mats = 3 if self.mlp_kind == "gated" else 2
        if self.family == "moe":
            assert self.moe is not None
            mlp = self.moe.num_experts * n_mlp_mats * d * self.d_ff
            if self.moe.num_shared_experts:
                sdff = self.moe.shared_expert_d_ff or self.d_ff
                mlp += n_mlp_mats * d * sdff
            mlp += d * self.moe.num_experts  # router
        elif self.family == "ssm":
            # xLSTM: rough (projections + gates), as the JAX formula
            mlp = 0
            pf = self.xlstm.mlstm_proj_factor if self.xlstm else 2.0
            att = int(4 * d * d * pf)
        else:
            mlp = n_mlp_mats * d * self.d_ff
        blocks = L * (att + mlp + 2 * d)
        if self.family == "encdec" and self.encdec is not None:
            blocks += self.encdec.num_encoder_layers * (att + mlp + 2 * d)
            blocks += L * att            # decoder cross-attention
        return emb + blocks + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        n_mlp_mats = 3 if self.mlp_kind == "gated" else 2
        dense_like = self.param_count() - L * (
            self.moe.num_experts * n_mlp_mats * d * self.d_ff)
        active_mlp = L * self.moe.top_k * n_mlp_mats * d * self.d_ff
        return dense_like + active_mlp


@dataclass(frozen=True)
class InputShape:
    """One input shape of the dry run and the mesh placements: sequence
    length, global batch and mode (``train``, ``prefill``, ``decode``)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    """The names of every config the port holds (``repro_torch.configs``
    registers them all when it is imported)."""
    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, *, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4, vocab: int = 512) -> ArchConfig:
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
        remat=False,
        dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            shared_expert_d_ff=0,
        )
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, lru_width=0)
    if cfg.xlstm is not None:
        changes["xlstm"] = dataclasses.replace(
            cfg.xlstm, slstm_at=tuple(i for i in cfg.xlstm.slstm_at
                                      if i < num_layers) or (0,))
    if cfg.encdec is not None:
        changes["encdec"] = dataclasses.replace(
            cfg.encdec, num_encoder_layers=num_layers, encoder_seq_len=32)
    return dataclasses.replace(cfg, **changes)
