"""H2O-Danube3-4B [arXiv:2401.16818] — llama+mistral mix with SWA."""
from repro_torch.configs.base import ArchConfig, register

H2O_DANUBE_3_4B = register(ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    citation="arXiv:2401.16818",
    head_dim=120,
    sliding_window=4096,
    act="silu",
    mlp_kind="gated",
))
