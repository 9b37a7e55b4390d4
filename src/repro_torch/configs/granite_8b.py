"""IBM Granite 8B code model [arXiv:2405.04324] — llama-arch dense decoder."""
from repro_torch.configs.base import ArchConfig, register

GRANITE_8B = register(ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    citation="arXiv:2405.04324",
    rope_theta=10000.0,
    act="silu",
    mlp_kind="gated",
))
