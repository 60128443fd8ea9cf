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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.repulsion.ref import (
    repulsion_chunked,
    repulsion_chunked_rows,
    repulsion_ref,
)

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int
] + [ctypes.c_void_p] * 3
_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int
] + [ctypes.c_void_p] * 3

# The kernel's geometry (csrc/repulsion_nbody.cu): nodes per block and
# sources per shared-memory tile.
NODES_PER_BLOCK = 256
SOURCE_TILE = 256
BLOCKS_PER_SM = 8  # enough resident blocks to hide the per-pair latency
MAX_SLICES = 16  # scratch ≤ 16 · n · 8 bytes


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


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def repulsion(pos, mass, kr: float, radii=None):
    """FA2 repulsion forces. pos [n,2], mass [n] (radii [n] or None) → [n,2].

    Padded entries must carry mass 0 (they then exert/receive no force).
    """
    dev = pos.device
    n = pos.shape[0]
    if dev.type == "cpu":
        if n <= 2048:
            return repulsion_ref(pos, mass, kr, radii=radii)
        return repulsion_chunked(pos, mass, kr, radii=radii)
    if dev.type != "cuda":
        raise ValueError(f"repulsion: unsupported device {dev}")
    build.require(pos, "pos", torch.float32, dev, (n, 2))
    build.require(mass, "mass", torch.float32, dev, (n,))
    if radii is not None:
        build.require(radii, "radii", torch.float32, dev, (n,))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    slices = source_slices(n, _sm_count(dev.index if dev.index is not None
                                        else torch.cuda.current_device()))
    scratch = torch.empty((slices, n, 2), dtype=torch.float32, device=dev) if slices > 1 else None
    fn = build.entry("repulsion_nbody", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(mass),
            build.ptr(radii) if radii is not None else None,
            n, float(kr), int(radii is not None), slices,
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
    if dev.type == "cpu":
        if n <= 2048:
            return repulsion_ref(pos, mass, kr, radii=radii)[i0:i0 + nl]
        return repulsion_chunked_rows(pos, mass, i0, nl, kr, radii=radii)
    if dev.type != "cuda":
        raise ValueError(f"repulsion_rows: unsupported device {dev}")
    build.require(pos, "pos", torch.float32, dev, (n, 2))
    build.require(mass, "mass", torch.float32, dev, (n,))
    if radii is not None:
        build.require(radii, "radii", torch.float32, dev, (n,))
    out = torch.empty((nl, 2), dtype=torch.float32, device=dev)
    slices = source_slices(n, _sm_count(dev.index if dev.index is not None
                                        else torch.cuda.current_device()))
    scratch = (torch.empty((slices, nl, 2), dtype=torch.float32, device=dev)
               if slices > 1 else None)
    fn = build.entry("repulsion_nbody", _ROWS_ARGTYPES, "repulsion_nbody_rows")
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(mass),
            build.ptr(radii) if radii is not None else None,
            n, int(i0), int(nl), float(kr), int(radii is not None), slices,
            build.ptr(scratch) if scratch is not None else None,
            build.ptr(out), build.stream(dev),
        )
    build.check("repulsion_nbody", code)
    build.LAUNCHES["repulsion_rows"] += 1
    return out
