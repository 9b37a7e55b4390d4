"""Compressed model exchange: codecs that encode, decode and price the
wire of every consensus round (see :mod:`repro_torch.comms.codecs`)."""
from repro_torch.comms.codecs import (  # noqa: F401
    CODECS,
    Bf16Codec,
    Codec,
    ErrorFeedback,
    IdentityCodec,
    IntCodec,
    TopKCodec,
    get_codec,
    resolve_codec,
)
