"""Shared building blocks. This slice ports only the initializer the DQN
uses."""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(shape, *, generator: Optional[torch.Generator] = None,
               dtype=torch.float32, device="cuda",
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±3, times
    ``scale`` or 1/√fan_in (fan-in is the first dimension)."""
    fan_in = max(shape[0], 1)
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(dtype)
