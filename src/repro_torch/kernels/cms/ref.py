"""Plain PyTorch version of the count–min sketch update (kernel K8).

Given hashed buckets ``h`` [rows, n] and weights ``w`` [n], add ``w[e]`` at
``sketch[r, h[r, e]]`` for every row r, into a copy of the sketch. A bucket
outside ``[0, cols)`` (the padding mark −1) drops that slot alone, in any
row — the kernel's semantics and that of the reference's Pallas kernel. (The
reference's own plain version masks on row 0 only and clamps a negative
bucket of a later row to column 0; its entry point ``ops.update`` never
produces such input, since padding is −1 in every row.)
"""
from __future__ import annotations

import torch


def cms_update_ref(sketch, h, w):
    rows, n = h.shape
    keep = (h >= 0) & (h < sketch.shape[1])
    r = torch.arange(rows, device=h.device)[:, None].expand(rows, n)
    wv = w.to(sketch.dtype)[None, :].expand(rows, n)
    out = sketch.clone()
    out.index_put_((r[keep], h[keep].long()), wv[keep], accumulate=True)
    return out
