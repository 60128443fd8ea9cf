"""Plain PyTorch versions of the segment sum (kernel K7) and its layout
entries.

``out[seg[e]] += data[e]`` for ``[E, D]`` data into ``[N, D]``, accumulated
in float32 and cast back to the data's type. Ids outside ``[0, N)``,
negatives included (the edge-padding trash id ``N`` among them), are
dropped, as the reference's segment sum drops them.

One ``index_add_`` over the kept rows. On the CPU that adds each row into
its segment in row order, one rounding per row, which is the order kernel
K7 sums in, so the two agree bitwise; on the card ``index_add_`` runs on
float atomics in no fixed order.

A segment layout (``segment_layout_ref``) is the stable order of the rows
by id and the first sorted row of each segment; ``segment_sum_layout_ref``
and ``attraction_sum_ref`` sum through one, each segment's rows in that
order, so they give the bits of ``segment_sum_ref`` on the same ids (and
of FA2's CPU attraction, for the latter).
"""
from __future__ import annotations

import torch


def segment_sum_ref(data, seg_ids, n_segments: int, indices_are_sorted: bool = False):
    """[E, D] (or [E]) data, [E] int ids → [n_segments, D] sums.

    ``indices_are_sorted`` is the reference's hint; the result does not
    depend on it."""
    del indices_are_sorted
    keep = (seg_ids >= 0) & (seg_ids < n_segments)
    out = torch.zeros((n_segments,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, seg_ids[keep].long(), data[keep].to(torch.float32))
    return out.to(data.dtype)


def segment_layout_ref(ids, n_segments: int, sorted: bool = False):
    """``(perm, offsets)`` of int ids [E] over ``n_segments`` segments:
    ``perm`` the int32 stable order of the rows by id (None when ``sorted``
    promises ascending ids), ``offsets`` int32 [N + 1], ``offsets[s]`` the
    first sorted row whose id is ≥ s. Rows with ids < 0 or ≥ N fall outside
    every ``[offsets[s], offsets[s + 1])``."""
    ids = ids.to(torch.int32)
    if sorted:
        sid, perm = ids, None
    else:
        sid, order = torch.sort(ids, stable=True)
        perm = order.to(torch.int32)
    return perm, segment_offsets_ref(sid, n_segments)


def segment_offsets_ref(sid, n_segments: int):
    """int32 [N + 1]: ``offsets[s]`` the first row of the ascending int32
    ids ``sid`` whose id is ≥ s."""
    marks = torch.arange(n_segments + 1, dtype=torch.int32, device=sid.device)
    return torch.searchsorted(sid, marks).to(torch.int32)


def _segment_of_rows(offsets):
    """The rows ``[offsets[0], offsets[N])`` of the sorted order and the
    segment of each, [rows] int64."""
    n = offsets.numel() - 1
    lo, hi = int(offsets[0]), int(offsets[n])
    seg = torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                  torch.diff(offsets).long(), output_size=hi - lo)
    return lo, hi, seg


def segment_sum_layout_ref(data, perm, offsets):
    """[E, D] (or [E]) data summed through a layout → [N, D]: segment s adds
    ``data[perm[r]]`` (``data[r]`` with no ``perm``) for r in
    ``[offsets[s], offsets[s + 1])``, in that order, in float32."""
    lo, hi, seg = _segment_of_rows(offsets)
    rows = data[lo:hi] if perm is None else data[perm[lo:hi].long()]
    out = torch.zeros((offsets.numel() - 1,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=data.device)
    out.index_add_(0, seg, rows.to(torch.float32))
    return out.to(data.dtype)


def attraction_sum_ref(pos, dst, w, offsets):
    """FA2's attraction through the source-sorted layout ``offsets`` of n =
    ``len(pos)`` nodes: node s adds ``w[r]·(pos_ext[dst[r]] − pos[s])`` for
    r in ``[offsets[s], offsets[s + 1])`` in row order, ``pos_ext`` being
    ``pos`` with a zero row n and ``dst`` clamped into ``[0, n]``. The
    arithmetic of the CPU form ``w[:, None] * (pos_ext[d] − pos_ext[s])``
    summed by ``index_add_``. A half-width layout (bfloat16, float16) is
    widened to float32, formed and summed as a float32 layout is, and each
    node's sum rounded once to its type."""
    n, dtype = pos.shape[0], pos.dtype
    wide = torch.promote_types(dtype, torch.float32)
    pos, w = pos.to(wide), w.to(wide)
    lo, hi, seg = _segment_of_rows(offsets)
    pos_ext = torch.cat([pos, torch.zeros((1, 2), dtype=wide, device=pos.device)])
    d = dst[lo:hi].long().clamp(0, n)
    f = w[lo:hi, None] * (pos_ext[d] - pos[seg])
    out = torch.zeros((n, 2), dtype=wide, device=pos.device).index_add_(0, seg, f)
    return out.to(dtype)
