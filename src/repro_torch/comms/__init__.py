"""Compressed model exchange: codecs that encode, decode and price the
wire of every consensus round (see :mod:`repro_torch.comms.codecs`), and
the "auto" wire format picked from link quality
(:mod:`repro_torch.comms.select`)."""
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
from repro_torch.comms.select import (  # noqa: F401
    BF16_MIN_BIT_PER_JOULE,
    INT8_MIN_BIT_PER_JOULE,
    link_efficiencies,
    select_codec,
)
