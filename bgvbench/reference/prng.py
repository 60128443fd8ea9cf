"""Counter-based uniform draw for the layout's starting positions.

Threefry-2x32 (20 rounds) in the partitionable form: element ``i`` of a
draw under key ``(0, seed mod 2**32)`` takes the 32 bits ``x0 ^ x1`` of
``threefry2x32(key, (i >> 32, i mod 2**32))``. The top 23 bits make a
float32 in [1, 2); minus one, scaled by the span and shifted by the lower
bound, it is rounded once to float32. The word arithmetic runs on int64
tensors masked to 32 bits.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for j in range(5):
        for r in _ROT[j % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(j + 1) % 3]) & _MASK
        x1 = (x1 + ks[(j + 2) % 3] + j + 1) & _MASK
    return x0, x1


def uniform_f32(seed: int, shape, lo: float, hi: float, device="cpu"):
    """float32 values in [lo, hi) of ``shape`` for ``seed``."""
    m = 1
    for s in shape:
        m *= int(s)
    i = torch.arange(m, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(0, int(seed) & _MASK, i >> 32, i & _MASK)
    bits = (x0 ^ x1) >> 9  # 23 mantissa bits
    f = bits.to(torch.float64) / float(1 << 23)  # exact, in [0, 1)
    lo32 = torch.tensor(lo, dtype=torch.float32).item()
    hi32 = torch.tensor(hi, dtype=torch.float32).item()
    span = torch.tensor(hi32 - lo32, dtype=torch.float64).to(torch.float32).item()
    val = (f * span + lo32).to(torch.float32)  # the float64 value is exact
    return torch.clamp(val, min=lo32).reshape(tuple(int(s) for s in shape))
