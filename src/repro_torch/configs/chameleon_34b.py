"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM.

Image tokens are VQ codes folded into the 65536 vocabulary; the VQ-VAE
tokenizer is the stubbed modality frontend. The backbone is
a dense llama-style decoder with qk-norm (per the Chameleon paper).
"""
from repro_torch.configs.base import ArchConfig, register

CHAMELEON_34B = register(ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    citation="arXiv:2405.09818",
    use_qk_norm=True,
    act="silu",
    mlp_kind="gated",
))
