"""Whisper large-v3 [arXiv:2212.04356] — encoder-decoder audio transformer.

The mel-spectrogram + conv frontend is a stub: the encoder takes
precomputed (batch, 1500, d_model) frame embeddings
(:mod:`repro_torch.models.frontend`). Decoder max context 448.
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig, register

WHISPER_LARGE_V3 = register(ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,                 # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    citation="arXiv:2212.04356",
    encdec=EncDecConfig(num_encoder_layers=32, encoder_seq_len=1500,
                        max_decoder_ctx=448),
    act="gelu",
    mlp_kind="plain",
    rope_theta=0.0,                # sinusoidal absolute positions
))
