"""Learning-rate schedules (int32 step tensor -> f32 lr tensor): the port
of the JAX package's ``optim/schedules.py``. The lr is a fill on the step's
device, never a host copy, so a schedule runs inside a captured step."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _fill(lr: float, step):
    return torch.full((), lr, dtype=_F32, device=step.device)


def constant(lr: float):
    return lambda step: _fill(lr, step)


def cosine_decay(lr: float, steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(step.to(_F32) / steps, 0.0, 1.0)
        c = 0.5 * (1 + torch.cos(math.pi * t))
        return _fill(lr, step) * (final_frac + (1 - final_frac) * c)
    return f


def warmup_cosine(lr: float, warmup: int, steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(steps - warmup, 1), final_frac)

    def f(step):
        s = step.to(_F32)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(step <= warmup, _fill(lr, step) * w,
                           cos(step - warmup))
    return f
