"""RecurrentGemma-9B / Griffin [arXiv:2402.19427] — RG-LRU + local attention 1:2.

Block pattern (recurrent, recurrent, attention) repeated; local (sliding
window 2048) attention, MQA (1 kv head).
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig, register

RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    citation="arXiv:2402.19427",
    head_dim=256,
    sliding_window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv1d_width=4,
                      block_pattern=("recurrent", "recurrent", "attention")),
    act="gelu",
    mlp_kind="gated",
    logit_softcap=30.0,
))
