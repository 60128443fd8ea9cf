"""Public wrapper for FA2 n-body repulsion: kernel K2
(``csrc/repulsion_nbody.cu``) for CUDA tensors; on the CPU the dense plain
version up to 2048 nodes and the j-chunked one above. A tensor anywhere
else raises.

The kernel splits the source axis into ``source_slices(n, sms)`` slices so
that the card fills at the supergraph's sizes; each slice's partial forces
go to a ``[S, n, 2]`` scratch buffer allocated here, which the kernel's
second pass adds in slice order.

``repulsion_rows`` computes only the targets ``[i0, i0 + nl)`` against all
n sources (the sharded layout's owned rows): the kernel's row-range entry
on the card, with the slices of the whole n and a ``[S, nl, 2]`` scratch,
so its rows are bitwise those of the full launch; on the CPU the rows of
the same plain version ``repulsion`` takes.

Both entries take the layout's type (``FA2Config.dtype``): pos, mass and
radii all float32, bfloat16 or float16, and the forces come back in it.
The kernel reads the inputs in that type (no widened copy is made before
the launch), computes and sums in float32 and rounds each output once; the
scratch stays float32 and is used for every slice count when the type is
not float32.

A fake tensor takes the abstract rule (``build.route``): the output and
the scratch the card's call allocates, sized for the card's SM count
(132, the H100's, where no card is present), and ``repulsion_cost`` /
``repulsion_rows_cost`` of the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.repulsion.ref import (
    repulsion_chunked,
    repulsion_chunked_rows,
    repulsion_ref,
)

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int
] + [ctypes.c_void_p] * 3
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int,
] + [ctypes.c_void_p] * 3

# The kernel's geometry (csrc/repulsion_nbody.cu): nodes per block and
# sources per shared-memory tile.
NODES_PER_BLOCK = 256
SOURCE_TILE = 256
BLOCKS_PER_SM = 8  # enough resident blocks to hide the per-pair latency
MAX_SLICES = 16  # scratch ≤ 16 · n · 8 bytes
# Operations per pair: dx, dy (2); dx²+dy² (3); max ε² (1); sqrt (1); eff:
# d−ri−rj (2, radii only) and max ε (1); mi·mj (1); eff·d (1); divide (1);
# f += mag·dx, mag·dy (4). kr·mi is hoisted per node.
OPS_PER_PAIR = {True: 17, False: 15}


def repulsion_cost(n: int, radii: bool, size: int = 4) -> tuple[int, int]:
    """(operations, bytes) of one ``repulsion`` launch over n nodes in a
    layout type of ``size`` bytes an element: every pair's arithmetic; pos,
    mass (and radii) read and the forces written once."""
    return OPS_PER_PAIR[radii] * n * n, n * size * (5 + radii)


def repulsion_rows_cost(n: int, nl: int, radii: bool, size: int = 4) -> tuple[int, int]:
    """(operations, bytes) of one ``repulsion_rows`` launch: its nl rows
    against all n sources; every source read once, its rows written."""
    return OPS_PER_PAIR[radii] * nl * n, n * size * (3 + radii) + nl * 2 * size


def source_slices(n: int, sms: int) -> int:
    """Source slices S for ``n`` nodes on a card of ``sms`` SMs: enough node
    blocks × slices for ``BLOCKS_PER_SM`` blocks per SM, at most
    ``MAX_SLICES`` and at most one slice per source tile, at least 1."""
    node_blocks = max(-(-n // NODES_PER_BLOCK), 1)
    tiles = -(-n // SOURCE_TILE)
    want = -(-BLOCKS_PER_SM * sms // node_blocks)
    return max(1, min(want, MAX_SLICES, tiles))


def slice_bounds(n: int, slices: int) -> list[tuple[int, int]]:
    """``[(j0, j1), ...]``: the sources of each slice, as the kernel computes
    them — slice s holds source tiles ``[s·T // S, (s+1)·T // S)`` of the
    ``T = ceil(n / SOURCE_TILE)`` tiles, the last one cut at n."""
    tiles = -(-n // SOURCE_TILE)
    return [(s * tiles // slices * SOURCE_TILE,
             min(n, (s + 1) * tiles // slices * SOURCE_TILE)) for s in range(slices)]


def _layout_type(pos, mass, radii, dev, n: int) -> torch.dtype:
    """The layout type of the card's inputs (one of ``build.FLOAT_CODES``,
    the same for all), checked with their shapes, device and layout."""
    dtype = pos.dtype
    if dtype not in build.FLOAT_CODES:
        raise TypeError(f"pos: dtype {dtype}, expected one of {tuple(build.FLOAT_CODES)}")
    build.require(pos, "pos", dtype, dev, (n, 2))
    build.require(mass, "mass", dtype, dev, (n,))
    if radii is not None:
        build.require(radii, "radii", dtype, dev, (n,))
    return dtype


def _scratch(slices: int, rows: int, dtype: torch.dtype, dev):
    """The float32 [S, rows, 2] partials, or None for one float32 slice
    (written to the output directly)."""
    if slices == 1 and dtype == torch.float32:
        return None
    return torch.empty((slices, rows, 2), dtype=torch.float32, device=dev)


def repulsion(pos, mass, kr: float, radii=None):
    """FA2 repulsion forces. pos [n,2], mass [n] (radii [n] or None) → [n,2].

    Padded entries must carry mass 0 (they then exert/receive no force).
    """
    dev = pos.device
    n = pos.shape[0]
    form = build.route(pos, "repulsion")
    if form == "plain":
        if n <= 2048:
            return repulsion_ref(pos, mass, kr, radii=radii)
        return repulsion_chunked(pos, mass, kr, radii=radii)
    dtype = _layout_type(pos, mass, radii, dev, n)
    out = torch.empty((n, 2), dtype=dtype, device=dev)
    slices = source_slices(n, build.sm_count(dev))
    scratch = _scratch(slices, n, dtype, dev)
    if form == "rule":
        del scratch
        return build.rule("repulsion_nbody", out,
                          *repulsion_cost(n, radii is not None, pos.element_size()))
    fn = build.entry("repulsion_nbody", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(mass),
            build.ptr(radii) if radii is not None else None,
            n, float(kr), int(radii is not None), slices, build.FLOAT_CODES[dtype],
            build.ptr(scratch) if scratch is not None else None,
            build.ptr(out), build.stream(dev),
        )
    build.check("repulsion_nbody", code)
    build.LAUNCHES["repulsion_nbody"] += 1
    return out


def repulsion_rows(pos, mass, i0: int, nl: int, kr: float, radii=None):
    """Rows ``[i0, i0 + nl)`` of ``repulsion(pos, mass, kr, radii)`` → [nl, 2],
    bitwise, computing only those rows' forces (on the CPU at n ≤ 2048 the
    dense plain version is cheap enough to run whole and slice)."""
    dev = pos.device
    n = pos.shape[0]
    if not 0 <= i0 <= n - nl or nl < 0:
        raise ValueError(f"repulsion_rows: rows [{i0}, {i0 + nl}) outside [0, {n})")
    form = build.route(pos, "repulsion_rows")
    if form == "plain":
        if n <= 2048:
            return repulsion_ref(pos, mass, kr, radii=radii)[i0:i0 + nl]
        return repulsion_chunked_rows(pos, mass, i0, nl, kr, radii=radii)
    dtype = _layout_type(pos, mass, radii, dev, n)
    out = torch.empty((nl, 2), dtype=dtype, device=dev)
    slices = source_slices(n, build.sm_count(dev))
    scratch = _scratch(slices, nl, dtype, dev)
    if form == "rule":
        del scratch
        return build.rule("repulsion_rows", out, *repulsion_rows_cost(
            n, nl, radii is not None, pos.element_size()))
    fn = build.entry("repulsion_nbody", _ROWS_ARGTYPES, "repulsion_nbody_rows")
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(mass),
            build.ptr(radii) if radii is not None else None,
            n, int(i0), int(nl), float(kr), int(radii is not None), slices,
            build.FLOAT_CODES[dtype],
            build.ptr(scratch) if scratch is not None else None,
            build.ptr(out), build.stream(dev),
        )
    build.check("repulsion_nbody", code)
    build.LAUNCHES["repulsion_rows"] += 1
    return out
