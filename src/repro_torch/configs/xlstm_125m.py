"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM block stack (d_ff=0: the
blocks carry their own up/down projections; no separate MLP)."""
from repro_torch.configs.base import ArchConfig, XLSTMConfig, register

XLSTM_125M = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    citation="arXiv:2405.04517",
    head_dim=192,
    xlstm=XLSTMConfig(slstm_at=(1, 4, 7, 10), mlstm_proj_factor=2.0),
    act="gelu",
    mlp_kind="plain",
))
