"""StableLM-2 family [hf:stabilityai/stablelm-2-1_6b] — dense decoder (MHA)."""
from repro_torch.configs.base import ArchConfig, register

STABLELM_3B = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    citation="hf:stabilityai/stablelm-2-1_6b",
    rope_theta=10000.0,
    act="silu",
    mlp_kind="gated",
))
