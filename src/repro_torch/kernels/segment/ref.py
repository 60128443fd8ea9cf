"""Plain PyTorch version of the segment sum (kernel K7).

``out[seg[e]] += data[e]`` for ``[E, D]`` data into ``[N, D]``, accumulated
in float32 and cast back to the data's type. Ids outside ``[0, N)``,
negatives included (the edge-padding trash id ``N`` among them), are
dropped, as the reference's segment sum drops them.

One ``index_add_`` over the kept rows. On the CPU that adds each row into
its segment in row order, one rounding per row, which is the order kernel
K7 sums in, so the two agree bitwise; on the card ``index_add_`` runs on
float atomics in no fixed order.
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
