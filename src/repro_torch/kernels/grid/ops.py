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

``near_field_rows`` is K6's row range: the sorted rows ``[i0, i0 + nl)``
only, their ±W band read from the full arrays (the sharded layout's owned
rows; plain version ``ref.near_field_rows``), bitwise the same rows of
``near_field_sorted``. K5's entry takes a row range as it is (its rows are
independent), and K7's cell statistics stay whole.

A fake tensor takes each entry's abstract rule (``build.route``): the
output the card's call allocates, the launch skipped, and the launch's
operations and bytes from ``far_field_cost``, ``near_field_cost`` and
``near_field_rows_cost``, which ``chip_smoke.py``'s bound column reads as
well. K6's work depends on the data: a band slot costs one compare, and
only a slot whose node shares the row's cell costs the pair arithmetic. A
rule cannot read the cells, so it counts every in-range slot as such a
pair (the most the band can hold); the smoke passes the pairs its input
holds.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grid.ref import (
    bin_and_sort,
    far_field_ref,
    near_field_ref,
)
from repro_torch.kernels.grid.ref import near_field_rows as near_field_rows_ref
from repro_torch.kernels.segment import ops as segment_ops

_FAR_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p
] * 2
_NEAR_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p
] * 2
_NEAR_ROWS_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float
] + [ctypes.c_void_p] * 2
# K6 indexes in 32 bits, with room for one block (512 nodes) and its band.
NEAR_MAX_N = 2**31 - 1 - 2048
# K5, per (node, cell) pair: dx, dy (2); dx², dy² and their sum (3); max
# EPS2 (1); ·M_j (1, kr·m_i hoisted); divide (1); own-cell select (1);
# mag·dx, mag·dy (2); the two tile-sum adds (2).
FAR_OPS_PER_PAIR = 13
# K6: one compare per in-range band slot, and per same-cell pair dx, dy
# (2); dx², dy², sum (3); max (1); ·m_j (1); divide (1); mag·dx, mag·dy
# (2); two adds (2).
NEAR_OPS_PER_PAIR = 12


def far_field_cost(n: int, c: int) -> tuple[int, int]:
    """(operations, bytes) of one ``far_field`` launch: every (node, cell)
    pair's arithmetic; pos, mass and cell read (16 bytes a node), the cells'
    centroids and masses (12 bytes a cell) and the forces written (8 bytes
    a node) once."""
    return FAR_OPS_PER_PAIR * n * c, n * 24 + c * 12


def _clamped_sum(a: int, w: int, cap: int) -> int:
    """Σ_{k=1..w} min(cap, max(0, a − k))."""
    k1 = min(max(a - cap, 0), w)  # terms of value cap
    k2 = min(w, max(a, 0))  # a − k > 0 up to here
    tail = (k2 - k1) * a - (k2 * (k2 + 1) - k1 * (k1 + 1)) // 2 if k2 > k1 else 0
    return k1 * cap + tail


def near_field_rows_cost(n: int, window: int, i0: int, nl: int,
                         pairs: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one ``near_field_rows`` launch: one compare
    per band slot j = i ± k (1 ≤ k ≤ min(W, n − 1)) of its rows with 0 ≤ j
    < n, and ``NEAR_OPS_PER_PAIR`` per same-cell pair among them (``pairs``;
    None: every slot, the most the band can hold); the rows and their ±W
    band read (16 bytes a node), the rows' forces written (8 bytes)."""
    w = min(max(int(window), 0), max(n - 1, 0))
    slots = _clamped_sum(n - i0, w, nl) + _clamped_sum(i0 + nl, w, nl)
    band = min(n, i0 + nl + w) - max(0, i0 - w) if nl else 0
    return slots + NEAR_OPS_PER_PAIR * (slots if pairs is None else pairs), band * 16 + nl * 8


def near_field_cost(n: int, window: int, pairs: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one ``near_field_sorted`` launch: its rows
    are all n (``near_field_rows_cost``)."""
    return near_field_rows_cost(n, window, 0, n, pairs)


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
    form = build.route(pos, "far_field")
    if form == "plain":
        return far_field_ref(pos, mass, cell, ccent, cmass, kr)
    n, c = pos.shape[0], ccent.shape[0]
    build.require(pos, "pos", torch.float32, dev, (n, 2))
    build.require(mass, "mass", torch.float32, dev, (n,))
    build.require(cell, "cell", torch.int32, dev, (n,))
    build.require(ccent, "ccent", torch.float32, dev, (c, 2))
    build.require(cmass, "cmass", torch.float32, dev, (c,))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if form == "rule":
        return build.rule("far_field", out, *far_field_cost(n, c))
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
    form = build.route(pos_s, "near_field_sorted")
    if form == "plain":
        return near_field_ref(pos_s, mass_s, cell_s, kr, window)
    n = pos_s.shape[0]
    if n > NEAR_MAX_N:
        raise ValueError(f"near_field_sorted: {n} nodes, the kernel takes at most {NEAR_MAX_N}")
    build.require(pos_s, "pos_s", torch.float32, dev, (n, 2))
    build.require(mass_s, "mass_s", torch.float32, dev, (n,))
    build.require(cell_s, "cell_s", torch.int32, dev, (n,))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    if form == "rule":
        return build.rule("near_field", out, *near_field_cost(n, window))
    fn = build.entry("near_field", _NEAR_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(build.ptr(pos_s), build.ptr(mass_s), build.ptr(cell_s), n,
                  max(min(int(window), 2**31 - 1), 0), float(kr), build.ptr(out),
                  build.stream(dev))
    build.check("near_field", code)
    build.LAUNCHES["near_field"] += 1
    return out


def near_field_rows(pos_s, mass_s, cell_s, kr: float, window: int, i0: int, nl: int):
    """Rows ``[i0, i0 + nl)`` of ``near_field_sorted`` → [nl, 2] (sorted
    order), from the full sorted arrays."""
    dev = pos_s.device
    n = pos_s.shape[0]
    if not 0 <= i0 <= n - nl or nl < 0:
        raise ValueError(f"near_field_rows: rows [{i0}, {i0 + nl}) outside [0, {n})")
    form = build.route(pos_s, "near_field_rows")
    if form == "plain":
        return near_field_rows_ref(pos_s, mass_s, cell_s, kr, window, i0, nl)
    if n > NEAR_MAX_N:
        raise ValueError(f"near_field_rows: {n} nodes, the kernel takes at most {NEAR_MAX_N}")
    build.require(pos_s, "pos_s", torch.float32, dev, (n, 2))
    build.require(mass_s, "mass_s", torch.float32, dev, (n,))
    build.require(cell_s, "cell_s", torch.int32, dev, (n,))
    out = torch.empty((nl, 2), dtype=torch.float32, device=dev)
    if form == "rule":
        return build.rule("near_field_rows", out, *near_field_rows_cost(n, window, i0, nl))
    fn = build.entry("near_field", _NEAR_ROWS_ARGTYPES, "near_field_rows")
    with torch.cuda.device(dev):
        code = fn(build.ptr(pos_s), build.ptr(mass_s), build.ptr(cell_s), n, int(i0),
                  int(nl), max(min(int(window), 2**31 - 1), 0), float(kr),
                  build.ptr(out), build.stream(dev))
    build.check("near_field", code)
    build.LAUNCHES["near_field_rows"] += 1
    return out


def grid_repulsion(pos, mass, kr: float, grid_size: int, window: int,
                   cell=None, order=None, rows=None, gather=None):
    """Uniform-grid FA2 repulsion forces, pos [n, 2] → [n, 2].

    ``mass`` [n] (padding carries mass 0). ``cell``/``order`` (from
    ``bin_and_sort``) may be stale by up to ``grid_rebuild`` iterations; the
    monopole stats always follow the current positions, so staleness only
    blurs the cell partition, never the masses.

    With ``rows=(i0, nl)`` the two fields are computed for the sorted rows
    ``[i0, i0 + nl)`` only (K5 on those rows, K6's row entry) and
    ``gather`` (those rows of every rank → all n sorted rows, in order)
    assembles them before the unsort: the multi-device layout's form,
    bitwise the same forces."""
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
    if rows is None:
        force_s = far_field(pos_s, mass_s, cell_s, ccent, cmass, kr)
        force_s = force_s + near_field_sorted(pos_s, mass_s, cell_s, kr, window)
    else:
        i0, nl = rows
        r = slice(i0, i0 + nl)
        force_s = far_field(pos_s[r], mass_s[r], cell_s[r], ccent, cmass, kr)
        force_s = gather(force_s + near_field_rows(pos_s, mass_s, cell_s, kr, window,
                                                   i0, nl))
    out = torch.zeros_like(force_s)
    out[idx] = force_s
    return out.to(pos.dtype)
