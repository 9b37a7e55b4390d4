"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed top-4 + 4 shared.

Fine-grained experts (d_ff 1408 each); the 4 shared experts are modeled as
one merged shared expert of d_ff 4*1408=5632 (mathematically identical for
always-on experts).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

QWEN2_MOE_A2_7B = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    moe=MoEConfig(num_experts=60, top_k=4, num_shared_experts=1,
                  shared_expert_d_ff=5632),
    act="silu",
    mlp_kind="gated",
    rope_theta=1e6,
))
