"""Plain PyTorch versions of the rasterization primitives (kernels K3, K4).

All accumulate **int32 counts** — integer adds are associative, so
chunked accumulation is bit-identical to one-shot whatever the chunk order
(the renderer's streaming contract):

* ``count_scatter_into_ref`` — add per-sample increments into a flat
  accumulation buffer, in place (edge splatting). Positions outside
  ``[0, size)`` (the renderer marks dropped samples INT32_MAX) are
  skipped.
* ``count_disks_into_ref`` — the small-disk node pass: every disk's
  ``BBOX``×``BBOX`` pixel box, materialised as flat indices and scattered
  by ``count_scatter_into_ref``. Kernel K3's ``count_disks`` entry
  generates the same pixels, with the same float32 operations, inside the
  kernel.
* ``disk_accum_ref`` — dense per-pixel disk coverage: for every pixel and
  every node, test ``(x − cx)² + (y − cy)² ≤ r²`` and count into the
  node's color-group channel. Evaluated in row bands so the [n, band, w]
  mask is the only transient; nodes with ``r ≤ 0`` and out-of-range groups
  contribute nothing. The predicate is the same float32 operations in the
  same order as kernel K4, so the two agree bit for bit.
* ``disk_accum_into_ref`` — the same counts added into a given
  accumulator, in place (the renderer's node pass adds them onto the
  small-disk counts).
"""
from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1
# The small-disk box: it holds every pixel a disk of radius ≤ SMALL_R can
# cover, whatever the centre's fraction (the renderer sends count_disks
# only such disks). csrc/count_scatter.cu compiles the same BBOX.
SMALL_R = 8.0
BBOX = 2 * (int(SMALL_R) + 1)


def to_pixel(x):
    """floor(x) as int64 with float→int32 conversion semantics that do not
    depend on the device: NaN → 0, out-of-range values saturate (far
    outside any image, so they are dropped by the bounds checks)."""
    x = torch.nan_to_num(torch.floor(x), nan=0.0)
    return torch.clamp(x, -(2.0**30), 2.0**30).long()


def count_scatter_into_ref(acc, pos, inc=None):
    """``acc[pos] += inc`` in place for ``0 ≤ pos < len(acc)``; returns acc.

    ``inc=None`` means unit increments.
    """
    size = acc.shape[0]
    keep = (pos >= 0) & (pos < size)
    idx = torch.where(keep, pos, 0).long()
    val = torch.ones_like(pos, dtype=torch.int32) if inc is None else inc
    acc.index_add_(0, idx, torch.where(keep, val, 0).to(torch.int32))
    return acc


def count_disks_into_ref(acc, px, py, r, group, n_groups: int):
    """Add the small disks' pixel counts into ``acc`` [n_groups, hs, ws]
    int32, in place; returns acc.

    Disk k counts the pixels of the ``BBOX``×``BBOX`` grid around
    ``to_pixel(px, py)`` where (x−px)² + (y−py)² ≤ r² in float32; pixels
    outside the image, disks with r ≤ 0 (or NaN) and out-of-range groups
    count nothing. Materialises ``BBOX``² flat indices a disk.
    """
    _, hs, ws = acc.shape
    bx = to_pixel(px) - BBOX // 2  # [m]
    by = to_pixel(py) - BBOX // 2
    d = torch.arange(BBOX, device=px.device)
    xs = bx[:, None] + d[None, :]  # [m, B]
    ys = by[:, None] + d[None, :]
    dxv = xs.to(torch.float32) - px[:, None]
    dyv = ys.to(torch.float32) - py[:, None]
    dx2, dy2 = dxv * dxv, dyv * dyv
    inside = dy2[:, :, None] + dx2[:, None, :] <= (r * r)[:, None, None]
    g = group.long()
    ok = (
        inside
        & (r > 0)[:, None, None]
        & ((g >= 0) & (g < n_groups))[:, None, None]
        & ((ys >= 0) & (ys < hs))[:, :, None]
        & ((xs >= 0) & (xs < ws))[:, None, :]
    )
    flat = (g[:, None, None] * hs + ys[:, :, None]) * ws + xs[:, None, :]
    flat = torch.where(ok, flat, _INT32_MAX).to(torch.int32)
    count_scatter_into_ref(acc.view(-1), flat.reshape(-1), None)
    return acc


def disk_accum_ref(cx, cy, r, group, n_groups: int, h: int, w: int,
                   band: int = 8):
    """Per-pixel disk coverage counts, [n_groups, h, w] int32."""
    dev = cx.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    dx = xs[None, :] - cx[:, None]
    dx2 = dx * dx  # [n, w]
    r2 = (r * r)[:, None, None]
    alive = (r > 0)[:, None, None]
    # Out-of-range groups go to the scratch channel n_groups, cut off below.
    grp = torch.where((group >= 0) & (group < n_groups), group, n_groups).long()
    out = torch.zeros((n_groups + 1, h, w), dtype=torch.int32, device=dev)
    for y0 in range(0, h, band):
        y1 = min(h, y0 + band)
        ys = torch.arange(y0, y1, dtype=torch.float32, device=dev)
        dy = ys[None, :] - cy[:, None]
        dy2 = dy * dy  # [n, band]
        inside = ((dy2[:, :, None] + dx2[:, None, :]) <= r2) & alive
        out[:, y0:y1].index_add_(0, grp, inside.to(torch.int32))
    return out[:n_groups]


def disk_accum_into_ref(acc, cx, cy, r, group, n_groups: int):
    """``acc += disk_accum_ref(...)`` in place for ``acc`` [n_groups, h, w]
    int32; returns acc."""
    _, h, w = acc.shape
    acc += disk_accum_ref(cx, cy, r, group, n_groups, h, w)
    return acc
