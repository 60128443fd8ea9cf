"""Plain PyTorch versions of the rasterization primitives (kernels K3, K4).

Both accumulate **int32 counts** — integer adds are associative, so
chunked accumulation is bit-identical to one-shot whatever the chunk order
(the renderer's streaming contract):

* ``count_scatter_into_ref`` — add per-sample increments into a flat
  accumulation buffer, in place (edge splatting and the small-disk node
  pass). Positions outside ``[0, size)`` (the renderer marks dropped
  samples INT32_MAX) are skipped.
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
