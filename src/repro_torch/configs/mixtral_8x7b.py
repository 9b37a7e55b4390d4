"""Mixtral 8x7B [arXiv:2401.04088] — 8-expert top-2 MoE with SWA(4096)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

MIXTRAL_8X7B = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    citation="arXiv:2401.04088",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    act="silu",
    mlp_kind="gated",
    rope_theta=1e6,
))
