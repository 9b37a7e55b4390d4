"""Modality frontend stubs: the port of the JAX package's
``models/frontend.py``.

For the audio arch (whisper) and the VLM arch (chameleon) the mel + conv
codec and the VQ-VAE image tokenizer are not implemented. These helpers
make the tensors such a frontend would emit, with the right shapes and
dtypes: random draws from an explicit ``torch.Generator`` (so they differ
from ``jax.random``'s), or a ``meta``-device tensor for shape-only runs.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dtype_of


def audio_frame_embeddings(generator: torch.Generator, cfg, batch: int, *,
                           device="cuda") -> torch.Tensor:
    """What the whisper conv frontend would emit: (B, T_enc, d) frames,
    N(0, 1) · 0.02 in ``cfg.dtype``."""
    shape = (batch, cfg.encdec.encoder_seq_len, cfg.d_model)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32).to(dtype_of(cfg.dtype))
    return x * 0.02


def audio_frame_spec(cfg, batch: int) -> torch.Tensor:
    """The frames' shape and dtype as a ``meta`` tensor (no storage)."""
    return torch.empty((batch, cfg.encdec.encoder_seq_len, cfg.d_model),
                       dtype=dtype_of(cfg.dtype), device="meta")


def vlm_token_stream(generator: torch.Generator, cfg, batch: int,
                     seq_len: int, *, device="cuda") -> torch.Tensor:
    """Chameleon early fusion: interleaved text + VQ image-code token ids.
    Image codes are ordinary vocabulary entries, so for training the
    stream is just ids in [0, vocab), int32."""
    return torch.randint(0, cfg.vocab_size, (batch, seq_len),
                         generator=generator, device=device,
                         dtype=torch.int32)
