"""Host-side helpers of the chunked round drivers.

The JAX package's scan loop also caches compiled chunk programs, donates
their buffers and probes samplers for traceability; eager PyTorch compiles
no chunk program, so none of that has a counterpart here."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def first_hit(reached_mask) -> Optional[int]:
    """Index of the first True in a per-round reached mask (host-side,
    one chunk), or None if the chunk never hit the target."""
    idx = np.flatnonzero(np.asarray(reached_mask))
    return int(idx[0]) if idx.size else None


def to_host(x: torch.Tensor) -> np.ndarray:
    """The drivers' one device→host read of a chunk (or, in streaming
    telemetry, of a round): waits for the device and copies ``x``."""
    return x.detach().cpu().numpy()
