"""Host-side helpers of the chunked round drivers."""
from __future__ import annotations

from typing import Optional

import numpy as np


def first_hit(reached_mask) -> Optional[int]:
    """Index of the first True in a per-round reached mask (host-side,
    one chunk), or None if the chunk never hit the target."""
    idx = np.flatnonzero(np.asarray(reached_mask))
    return int(idx[0]) if idx.size else None
