"""DeepSeek LLM 7B [arXiv:2401.02954] — llama-arch dense decoder (MHA)."""
from repro_torch.configs.base import ArchConfig, register

DEEPSEEK_7B = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    citation="arXiv:2401.02954",
    act="silu",
    mlp_kind="gated",
))
