"""The reference's seeded draws, bit for bit, in integer tensor arithmetic.

The reference draws its starting layouts from its array library's default
generator (release 0.9.0): threefry2x32 in the partitionable form. A seed's
key is the pair ``(0, seed mod 2**32)``, and element ``i`` of a draw
(row-major flat index) takes its 32 bits from ``x0 ^ x1``, where
``(x0, x1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``. ``uniform``
follows that library's uniform draw: the top mantissa bits of the draw
make a value in [1, 2) that becomes one in [0, 1), then scale and shift.
The compiled reference rounds that scale and shift once in float32 and
float16 (its CPU backend contracts it to a fused multiply-add) and after
each operation in bfloat16.

Every step is integer arithmetic on int64 tensors masked to 32 bits
(torch's ``uint32`` has no add, shift or remainder on the CPU) plus
correctly rounded float conversions, so a draw gives the same bits on the
CPU and on the card. A draw of ``m`` values holds a few int64 temporaries
of ``m`` elements.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# dtype -> (total bits, mantissa bits, integer type of the same width)
_FLOATS = {
    torch.float32: (32, 23, torch.int32),
    torch.bfloat16: (16, 7, torch.int16),
    torch.float16: (16, 10, torch.int16),
}
_ONE_BITS = {torch.float32: 0x3F800000, torch.bfloat16: 0x3F80, torch.float16: 0x3C00}


def key(seed: int) -> tuple[int, int]:
    """The reference's key for ``seed``: ``(0, seed mod 2**32)``."""
    return 0, int(seed) & _MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under the key ``(k0, k1)``; int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    # x1 is masked after every step; x0 only at the end: its 25 additions
    # of 32-bit words stay far below 2**63, and the xor's mask drops its
    # high bits.
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _MASK
    for j in range(5):
        for r in _ROTATIONS[j % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = x0 + ks[(j + 1) % 3]
        x1 = (x1 + (ks[(j + 2) % 3] + j + 1)) & _MASK
    return x0 & _MASK, x1


def random_bits(key: tuple[int, int], shape, width: int = 32, device="cpu"):
    """The reference's random bits for ``width`` 8, 16 or 32: the
    low ``width`` bits of ``x0 ^ x1`` for each element's flat index, as an
    int64 tensor of ``shape`` on ``device``."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits: width must be 8, 16 or 32, got {width}")
    shape = tuple(int(s) for s in shape)
    i = torch.arange(torch.Size(shape).numel(), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key[0], key[1], i >> 32, i & _MASK)
    return ((x0 ^ x1) & ((1 << width) - 1)).reshape(shape)


def _odd(r, inexact, up):
    """Round-to-odd: where ``r`` is inexact (the exact value lies above it
    where ``up``) and its last bit even, its neighbour on the exact value's
    side. A round-to-odd value rounded to nearest in a format two or more
    bits narrower is the exact value correctly rounded."""
    ibits = torch.int64 if r.dtype == torch.float64 else torch.int32
    toward = torch.where(up, torch.inf, -torch.inf).to(r.dtype)
    return torch.where(inexact & ((r.view(ibits) & 1) == 0), torch.nextafter(r, toward), r)


def _add(a, b, dtype):
    """``a + b`` (float64 operands, the sum exact in real arithmetic)
    rounded once to ``dtype``: the float64 sum and its exact error (two-sum)
    made round-to-odd, then narrowed through float32."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    s = _odd(s, e != 0, e > 0)
    if dtype == torch.float32:
        return s.to(dtype)
    r = s.to(torch.float32)
    return _odd(r, r.to(torch.float64) != s, s > r.to(torch.float64)).to(dtype)


def uniform(key: tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32, device="cpu"):
    """The reference's uniform draw: values in [minval, maxval) of
    ``dtype`` (float32, bfloat16 or float16) on ``device``, its bits for
    scalar bounds."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform: dtype must be one of {list(_FLOATS)}, got {dtype}")
    nbits, nmant, itype = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits, device)
    one = ((bits >> (rng_bits - nmant)) | _ONE_BITS[dtype]).to(itype).view(dtype)
    f = one.to(torch.float64) - 1.0  # exact: [1, 2) minus 1
    zero = torch.zeros((), dtype=torch.float64, device=device)

    def rounded(a, b=zero):
        return _add(a, b, dtype).to(torch.float64)

    lo = rounded(torch.tensor(minval, dtype=torch.float64, device=device))
    hi = rounded(torch.tensor(maxval, dtype=torch.float64, device=device))
    span = rounded(hi, -lo)
    if dtype == torch.bfloat16:  # rounded after the product and after the sum
        val = _add(rounded(f * span), lo, dtype)
    else:  # f·span is exact in float64: one rounding
        val = _add(f * span, lo, dtype)
    return torch.maximum(lo.to(dtype), val)
