"""The reference's seeded draws, bit for bit, in tensor arithmetic.

The reference draws its starting layouts and its weights from its array
library's default generator (release 0.9.0): threefry2x32 in the
partitionable form. A seed's key is the pair ``(0, seed mod 2**32)``, and
element ``i`` of a draw (row-major flat index) takes its 32 bits from
``x0 ^ x1``, where
``(x0, x1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``. ``uniform``
follows that library's uniform draw: the top mantissa bits of the draw
make a value in [1, 2) that becomes one in [0, 1), then scale and shift.
The compiled reference rounds that scale and shift once in float32 and
float16 (its CPU backend contracts it to a fused multiply-add) and after
each operation in bfloat16. ``split`` gives a key's subkeys, and
``normal`` that library's float32 normal draw: ``√2 · erf_inv(u)`` of a
uniform ``u`` on [nextafter(-1, 0), 1), through the compiled reference's
own ``erf_inv`` (two polynomials of degree 8 in ``-log1p(-u·u)``, each
Horner step a fused multiply-add) and its own float32 ``log1p``, operation
for operation, subnormal results flushed to zero as its CPU backend does.

Every step is integer arithmetic on int64 tensors masked to 32 bits
(torch's ``uint32`` has no add, shift or remainder on the CPU) plus
correctly rounded float conversions, or float32 values held in float64
and rounded once after each operation (a float64 sum, product, quotient
or square root of float32 values rounded to float32 is the float32
operation's result; a fused multiply-add goes through ``_add``), so a draw
gives the same bits on the CPU and on the card. A draw of ``m`` values
holds a few int64 temporaries of ``m`` elements; ``normal`` draws in
chunks of at most ``CHUNK`` values.
"""
from __future__ import annotations

import struct

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


def split(key: tuple[int, int], n: int = 2) -> list[tuple[int, int]]:
    """The reference's ``split``: subkey ``i`` is ``threefry2x32(key, (i >>
    32, i & 0xFFFFFFFF))``."""
    i = torch.arange(int(n), dtype=torch.int64)
    x0, x1 = threefry2x32(key[0], key[1], i >> 32, i & _MASK)
    return list(zip(x0.tolist(), x1.tolist()))


def random_bits(key: tuple[int, int], shape, width: int = 32, device="cpu", start: int = 0):
    """The reference's random bits for ``width`` 8, 16 or 32: the
    low ``width`` bits of ``x0 ^ x1`` for each element's flat index, as an
    int64 tensor of ``shape`` on ``device``. ``start`` offsets the flat
    indices: the bits of a draw's elements ``[start, start + numel)``."""
    if width not in (8, 16, 32):
        raise ValueError(f"random_bits: width must be 8, 16 or 32, got {width}")
    shape = tuple(int(s) for s in shape)
    i = torch.arange(start, start + torch.Size(shape).numel(), dtype=torch.int64, device=device)
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
            dtype=torch.float32, device="cpu", start: int = 0):
    """The reference's uniform draw: values in [minval, maxval) of
    ``dtype`` (float32, bfloat16 or float16) on ``device``, its bits for
    scalar bounds; ``start`` as in ``random_bits``."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform: dtype must be one of {list(_FLOATS)}, got {dtype}")
    nbits, nmant, itype = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits, device, start)
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


CHUNK = 1 << 24  # values a ``normal`` draw computes at once
_TINY = 2.0 ** -126  # float32's least normal magnitude


def _c(bits: int) -> float:
    """The float32 value of a bit pattern."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# The compiled reference's float32 log1p: a rational function of x where
# |x| < _LOG1P_SMALL, else the logarithm of 1 + x from its exponent and a
# polynomial in its mantissa.
_LOG1P_SMALL = _c(0x3ED413CD)
_LOG1P_NUM = [_c(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
                              0x426473AD, 0x41A05101)]
_LOG1P_DEN = [_c(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
                              0x42707982)]
_SQRT_HALF = _c(0x3F3504F3)
_LOG_A = [_c(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)]
_LOG_B = [_c(b) for b in (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)]
_LOG_C = [_c(b) for b in (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LN2_LO, _LN2_HI = _c(0xB95E8083), _c(0x3F318000)
# erf_inv's two polynomials (w < 5 and w >= 5), highest degree first.
_ERFINV_SMALL = [_c(b) for b in (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB,
                                 0xBAA45408, 0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F)]
_ERFINV_LARGE = [_c(b) for b in (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B,
                                 0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB, 0x40354F7E)]
_SQRT2 = _c(0x3FB504F3)
_NORMAL_LO = _c(0xBF7FFFFF)  # nextafter(-1, 0)


def _r(x):
    """A float64 tensor rounded once to float32, kept in float64."""
    return x.to(torch.float32).to(torch.float64)


def _ftz(x):
    """``x`` with subnormal float32 magnitudes flushed to a zero of its
    sign."""
    return torch.where(x.abs() < _TINY, x * 0.0, x)


def _fma(a, b, c):
    """``a·b + c`` of float32 values (float64 tensors or numbers) rounded
    once to float32: the product is exact in float64."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c))
    return _add(a * b, c, torch.float32).to(torch.float64)


def log1p(x):
    """The compiled reference's float32 ``log1p`` of the float32 values in
    the float64 tensor ``x``, as float32 values in float64; subnormal inputs
    read as zero and subnormal results flushed to zero, as its CPU backend
    does."""
    x = _ftz(x)
    # |x| small: x - x²/2 + x³·N(x)/D(x)
    x2 = _ftz(_r(x * x))
    den = _r(x + _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma(den, x, c)
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    cubic = _ftz(_r(_ftz(_r(x * x2)) * _r(num / den)))
    small = _r(x + _ftz(_r(x2 * -0.5 + cubic)))
    # otherwise: log(1 + x) = e·ln 2 + log(m), 1 + x = m·2^e, m in [√½, √2)
    xp1 = _r(x + 1.0)
    bits = torch.clamp(xp1, min=_TINY).to(torch.float32).view(torch.int32).to(torch.int64)
    m = ((bits & 0x7FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32).to(torch.float64)
    below = m < _SQRT_HALF
    t = torch.where(below, m + m, m) - 1.0  # exact
    e = ((bits >> 23) - 126 - below.to(torch.int64)).to(torch.float64)
    z = _r(t * t)
    t3 = _r(z * t)
    pa, pb, pc = (_fma(t, p[0], p[1]) for p in (_LOG_A, _LOG_B, _LOG_C))
    pa, pb, pc = (_fma(q, t, p[2]) for q, p in ((pa, _LOG_A), (pb, _LOG_B), (pc, _LOG_C)))
    poly = _fma(_fma(_fma(pa, t3, pb), t3, pc), t3, _r(e * _LN2_LO))
    big = _fma(e, _LN2_HI, _r(_r(t - z * 0.5) + poly))
    big = torch.where(xp1 == 0, -torch.inf, big)
    big = torch.where(xp1 == torch.inf, torch.inf, big)
    big = torch.where((xp1 < 0) | xp1.isnan(), torch.nan, big)
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


def _erf_inv(u):
    """The compiled reference's float32 ``erf_inv`` of the float32 values in
    the float64 tensor ``u`` (|u| < 1 or ±1)."""
    w = -log1p(_r(u * -u))
    lt5 = w < 5.0
    t = torch.where(lt5, _r(w - 2.5), _r(_r(w.sqrt()) - 3.0))
    p = torch.where(lt5, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, t, torch.where(lt5, a, b))
    p = torch.where(u.abs() == 1.0, torch.inf, p)
    return _r(u * p)


def normal(key: tuple[int, int], shape, dtype=torch.float32, device="cpu"):
    """The reference's float32 normal draw of ``shape`` on ``device``,
    computed ``CHUNK`` values at a time into the output."""
    if dtype != torch.float32:
        raise ValueError(f"normal: dtype must be float32 (the reference draws in float32 "
                         f"and casts), got {dtype}")
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32, device=device)
    flat = out.view(-1)
    for s in range(0, flat.numel(), CHUNK):
        m = min(CHUNK, flat.numel() - s)
        u = uniform(key, (m,), _NORMAL_LO, 1.0, torch.float32, device, s).to(torch.float64)
        flat[s:s + m] = _r(_erf_inv(u) * _SQRT2).to(torch.float32)
    return out
