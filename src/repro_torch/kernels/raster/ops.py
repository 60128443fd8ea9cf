"""Public wrappers for the raster primitives: kernels K3
(``csrc/count_scatter.cu``: ``count_scatter_into`` for the edge pass,
``count_disks_into`` for the small-disk node pass) and K4
(``csrc/disk_accum.cu``) for CUDA tensors, the plain PyTorch versions
(``ref.py``) for CPU tensors. A tensor anywhere else raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.raster.ref import (
    count_disks_into_ref,
    count_scatter_into_ref,
    disk_accum_into_ref,
)

_SCATTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_DISK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
_COUNT_DISKS_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def count_scatter_into(acc, pos, inc=None):
    """Add ``inc`` (None = 1) into ``acc`` at ``pos``, in place; returns acc.

    ``acc`` [size] int32, ``pos``/``inc`` [N] int32; positions outside
    ``[0, size)`` are dropped.
    """
    dev = acc.device
    if dev.type == "cpu":
        return count_scatter_into_ref(acc, pos, inc)
    if dev.type != "cuda":
        raise ValueError(f"count_scatter_into: unsupported device {dev}")
    n = pos.shape[0]
    build.require(acc, "acc", torch.int32, dev)
    build.require(pos, "pos", torch.int32, dev, (n,))
    if inc is not None:
        build.require(inc, "inc", torch.int32, dev, (n,))
    fn = build.entry("count_scatter", _SCATTER_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(inc) if inc is not None else None, n,
            acc.shape[0], build.ptr(acc), build.stream(dev),
        )
    build.check("count_scatter", code)
    build.LAUNCHES["count_scatter"] += 1
    return acc


def _disk_args(acc, cx, cy, r, group, n_groups: int, what: str):
    """Check a disk entry's arguments; returns the disk count."""
    dev = acc.device
    if acc.dim() != 3 or acc.shape[0] != n_groups:
        raise ValueError(f"{what}: acc shape {tuple(acc.shape)}, "
                         f"expected ({n_groups}, h, w)")
    build.require(acc, "acc", torch.int32, dev)
    n = cx.shape[0]
    for name, t, dt in (("cx", cx, torch.float32), ("cy", cy, torch.float32),
                        ("r", r, torch.float32), ("group", group, torch.int32)):
        build.require(t, name, dt, dev, (n,))
    return n


def count_disks_into(acc, px, py, r, group, n_groups: int):
    """Add the small-disk node pass's pixel counts into ``acc``
    [n_groups, hs, ws] int32, in place; returns acc.

    ``px``/``py``/``r`` [m] float32 pixel-space centres and radii, ``group``
    [m] int32. Each disk counts the pixels of the ``ref.BBOX``² box around
    its centre whose centres pass (x−px)² + (y−py)² ≤ r²; disks with
    ``r ≤ 0`` (or NaN) and out-of-range groups count nothing.
    """
    dev = acc.device
    if dev.type == "cpu":
        return count_disks_into_ref(acc, px, py, r, group, n_groups)
    if dev.type != "cuda":
        raise ValueError(f"count_disks_into: unsupported device {dev}")
    m = _disk_args(acc, px, py, r, group, n_groups, "count_disks_into")
    _, hs, ws = acc.shape
    fn = build.entry("count_scatter", _COUNT_DISKS_ARGTYPES, "count_disks")
    with torch.cuda.device(dev):
        code = fn(build.ptr(px), build.ptr(py), build.ptr(r), build.ptr(group), m,
                  n_groups, hs, ws, build.ptr(acc), build.stream(dev))
    build.check("count_scatter", code)
    build.LAUNCHES["count_disks"] += 1
    return acc


def count_scatter(pos, inc, size: int):
    """[N] positions + [N] increments → fresh [size] int32 counts."""
    acc = torch.zeros(size, dtype=torch.int32, device=pos.device)
    return count_scatter_into(acc, pos, inc)


def disk_accum_into(acc, cx, cy, r, group, n_groups: int):
    """Add per-pixel disk coverage counts by color group into ``acc``
    [n_groups, h, w] int32, in place; returns acc.

    ``cx``/``cy``/``r`` [n] float32 pixel-space centres and radii, ``group``
    [n] int32; nodes with ``r ≤ 0`` (or NaN) and out-of-range groups count
    nothing. Any ``n_groups``.
    """
    dev = acc.device
    if dev.type == "cpu":
        return disk_accum_into_ref(acc, cx, cy, r, group, n_groups)
    if dev.type != "cuda":
        raise ValueError(f"disk_accum_into: unsupported device {dev}")
    n = _disk_args(acc, cx, cy, r, group, n_groups, "disk_accum_into")
    _, h, w = acc.shape
    start = torch.empty(n + 1, dtype=torch.int64, device=dev)  # box-area prefix
    fn = build.entry("disk_accum", _DISK_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(cx), build.ptr(cy), build.ptr(r), build.ptr(group),
            n, n_groups, h, w, build.ptr(start), build.ptr(acc), build.stream(dev),
        )
    build.check("disk_accum", code)
    build.LAUNCHES["disk_accum"] += 1
    return acc


def disk_accum(cx, cy, r, group, n_groups: int, h: int, w: int):
    """Per-pixel disk coverage counts by color group, [n_groups, h, w] int32."""
    acc = torch.zeros((n_groups, h, w), dtype=torch.int32, device=cx.device)
    return disk_accum_into(acc, cx, cy, r, group, n_groups)
