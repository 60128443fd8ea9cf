"""Public wrappers for the uniform-grid repulsion family: kernels K5
(``csrc/far_field.cu``) and K6 (``csrc/near_field.cu``) for CUDA tensors, the
plain PyTorch versions (``ref.py``) for CPU tensors. A tensor anywhere else
raises.

``grid_repulsion`` is the whole stage: bin → stable sort → monopole stats
(one segment sum, kernel K7 on the card) → far field + banded near field in
sorted order → one unsorting scatter. ``cell``/``order`` may come from the
caller, so the FA2 loop can rebuild them every ``grid_rebuild`` iterations.
All math runs in float32 whatever the positions' type; the result is cast
back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grid.ref import bin_and_sort, far_field_ref, near_field_ref
from repro_torch.kernels.segment import ops as segment_ops

_FAR_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p
] * 2
_NEAR_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p
] * 2
# K6 indexes in 32 bits, with room for one block (512 nodes) and its band.
NEAR_MAX_N = 2**31 - 1 - 2048


def cell_stats(pos_s, mass_s, cell_s, n_cells: int):
    """(centroids [C, 2], masses [C]) per cell from cell-sorted nodes: one
    sorted segment sum over [m·x, m·y, m]; empty cells get mass 0
    (force-dead) and centroid 0."""
    data = torch.cat([pos_s * mass_s[:, None], mass_s[:, None]], dim=1)
    sums = segment_ops.segment_sum(data, cell_s, n_cells, indices_are_sorted=True)
    cmass = sums[:, 2].contiguous()
    ccent = sums[:, :2] / torch.clamp(cmass, min=1e-9)[:, None]
    return ccent, cmass


def far_field(pos, mass, cell, ccent, cmass, kr: float):
    """Monopole far field (own cell excluded) → [n, 2] float32."""
    dev = pos.device
    if dev.type == "cpu":
        return far_field_ref(pos, mass, cell, ccent, cmass, kr)
    if dev.type != "cuda":
        raise ValueError(f"far_field: unsupported device {dev}")
    n, c = pos.shape[0], ccent.shape[0]
    build.require(pos, "pos", torch.float32, dev, (n, 2))
    build.require(mass, "mass", torch.float32, dev, (n,))
    build.require(cell, "cell", torch.int32, dev, (n,))
    build.require(ccent, "ccent", torch.float32, dev, (c, 2))
    build.require(cmass, "cmass", torch.float32, dev, (c,))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    fn = build.entry("far_field", _FAR_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(build.ptr(pos), build.ptr(mass), build.ptr(cell), build.ptr(ccent),
                  build.ptr(cmass), n, c, float(kr), build.ptr(out), build.stream(dev))
    build.check("far_field", code)
    build.LAUNCHES["far_field"] += 1
    return out


def near_field_sorted(pos_s, mass_s, cell_s, kr: float, window: int):
    """Banded same-cell near field over the sorted order → [n, 2] (sorted)."""
    dev = pos_s.device
    if dev.type == "cpu":
        return near_field_ref(pos_s, mass_s, cell_s, kr, window)
    if dev.type != "cuda":
        raise ValueError(f"near_field_sorted: unsupported device {dev}")
    n = pos_s.shape[0]
    if n > NEAR_MAX_N:
        raise ValueError(f"near_field_sorted: {n} nodes, the kernel takes at most {NEAR_MAX_N}")
    build.require(pos_s, "pos_s", torch.float32, dev, (n, 2))
    build.require(mass_s, "mass_s", torch.float32, dev, (n,))
    build.require(cell_s, "cell_s", torch.int32, dev, (n,))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    fn = build.entry("near_field", _NEAR_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(build.ptr(pos_s), build.ptr(mass_s), build.ptr(cell_s), n,
                  max(min(int(window), 2**31 - 1), 0), float(kr), build.ptr(out),
                  build.stream(dev))
    build.check("near_field", code)
    build.LAUNCHES["near_field"] += 1
    return out


def grid_repulsion(pos, mass, kr: float, grid_size: int, window: int,
                   cell=None, order=None):
    """Uniform-grid FA2 repulsion forces, pos [n, 2] → [n, 2].

    ``mass`` [n] (padding carries mass 0). ``cell``/``order`` (from
    ``bin_and_sort``) may be stale by up to ``grid_rebuild`` iterations; the
    monopole stats always follow the current positions, so staleness only
    blurs the cell partition, never the masses."""
    pos32 = pos.to(torch.float32)
    mass32 = mass.to(torch.float32)
    if cell is None or order is None:
        cell, order = bin_and_sort(pos32, grid_size)
    idx = order.long()
    pos_s = pos32[idx]
    mass_s = mass32[idx]
    cell_s = cell[idx]
    ccent, cmass = cell_stats(pos_s, mass_s, cell_s, grid_size * grid_size)
    # Both fields run in sorted order → one unsorting scatter at the end.
    force_s = far_field(pos_s, mass_s, cell_s, ccent, cmass, kr)
    force_s = force_s + near_field_sorted(pos_s, mass_s, cell_s, kr, window)
    out = torch.zeros_like(force_s)
    out[idx] = force_s
    return out.to(pos.dtype)
