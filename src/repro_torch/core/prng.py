"""Counter-based threefry2x32 draws, bit-identical to ``jax.random``
(threefry PRNG, ``jax_threefry_partitionable=True``) on every device.

A key is an int64 tensor of shape (..., 2) holding the two uint32 words
of a JAX key; every function works on a whole tensor of keys at once, so
a (rounds, K, H) grid of per-edge draws is one vectorised call. uint32
values live in int64 tensors and are masked with ``0xFFFFFFFF`` after
each add and shift (``torch.uint32`` has few CUDA ops).

* ``PRNGKey(s)``      — ``(0, s)`` for 0 ≤ s < 2³²;
* ``fold_in(k, d)``   — ``threefry2x32(k, (0, d))``;
* ``bits(k)``         — a scalar draw's 32 bits, ``x0 ^ x1`` of
  ``threefry2x32(k, (0, 0))``;
* ``uniform(k)``      — ``float32_bits((bits >> 9) | 0x3F800000) - 1``,
  in [0, 1).

Only ``topology.survival_mask`` and ``topology.availability_mask``
compose ``uniform`` with ``fold_in``: they are the port's two draw sites.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def as_u32(x, device=None) -> torch.Tensor:
    """``x`` (int, array or tensor) as uint32 values in an int64 tensor."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher of JAX's PRNG over
    broadcastable uint32-in-int64 tensors: key words (k0, k1), counter
    words (x0, x1) → the two output words."""
    k0, k1, x0, x1 = torch.broadcast_tensors(k0, k1, x0, x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The (2,) key ``jax.random.PRNGKey(seed)`` holds."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(
            f"seed={seed} is outside [0, 2^32): pass a non-negative seed "
            "below 4294967296")
    return as_u32([0, seed], device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a tensor of keys (..., 2) and uint32
    ``data``, broadcast together → keys of the broadcast shape + (2,)."""
    d = as_u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack((y0, y1), -1)


def bits(key: torch.Tensor) -> torch.Tensor:
    """The 32 random bits of one scalar draw per key (..., 2) → (...)."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    return y0 ^ y1


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` (float32 in [0, 1)) per key (..., 2)."""
    b = (bits(key) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0
