"""Degrees, the count-min sketch, the supergraph, modularity and colours.

* graph degree: each edge adds one to both endpoints;
* δ: the most common nonzero degree;
* communities are renumbered densely in the order of their ids;
* a community's size is the count-min estimate of the sum of its nodes'
  degrees: 4 rows of multiply-shift hashes ``((a·k + b) mod 2^32) >> 5``
  modulo the width, constants drawn from NumPy's generator for the sketch's
  seed, the minimum over rows; ids at or past the live count read 0;
* superedges: the community pairs (min, max) of the edges between two
  communities below ``s_cap``, counted. The edges arrive in chunks; after
  each chunk the union of the kept pairs and the chunk's pairs is summed by
  pair and its lexicographically smallest ``cap`` pairs are kept, and the
  count is the union's number of pairs (a chunk without any such edge
  changes nothing);
* modularity (Newman): Σ_c e_c / m − (d_c / 2m)², in float64;
* colour groups (paper §4.3): communities sorted by size (stably); those
  whose running total stays within half of the total are group 0, the rest
  split by rank into 10 equal-count groups 1–10; size 0 is group 0.
"""
from __future__ import annotations

import numpy as np
import torch


def degrees(edges, n: int):
    e = edges.long()
    return torch.bincount(e.reshape(-1), minlength=n)[:n]


def mode_degree(edges_np: np.ndarray, n: int) -> int:
    deg = np.bincount(edges_np.reshape(-1), minlength=n)[:n]
    deg = deg[deg > 0]
    if deg.size == 0:
        return 1
    counts = np.bincount(deg)
    counts[0] = 0
    return int(np.argmax(counts))


def dense(labels):
    uniq = torch.unique(labels)
    return torch.searchsorted(uniq, labels), int(uniq.numel())


def cms_sizes(dense_labels, deg, n_live: int, s_cap: int, rows: int, cols: int,
              seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 2**31, size=rows, dtype=np.uint32).astype(np.int64) * 2 + 1
    b = rng.integers(0, 2**31, size=rows, dtype=np.uint32).astype(np.int64)
    dev = dense_labels.device
    at = torch.as_tensor(a & 0xFFFFFFFF, device=dev)[:, None]
    bt = torch.as_tensor(b, device=dev)[:, None]

    def buckets(keys):
        return (((at * keys[None, :] + bt) & 0xFFFFFFFF) >> 5) % cols

    h = buckets(dense_labels.long())
    sketch = torch.zeros((rows, cols), dtype=torch.int64, device=dev)
    for r in range(rows):
        sketch[r].index_add_(0, h[r], deg.long())
    keys = torch.arange(s_cap, dtype=torch.int64, device=dev)
    hq = buckets(keys)
    est = torch.stack([sketch[r][hq[r]] for r in range(rows)]).min(0).values
    return torch.where(keys < n_live, est, 0)


def superedges(edges, dense_labels, s_cap: int, cap: int, chunk: int):
    """→ (a [cap], b [cap], w [cap] int64, count): kept pairs in order,
    padded with (s_cap, s_cap, 0)."""
    dev = edges.device
    lab = dense_labels.long()
    base = s_cap + 1
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    wts = torch.empty(0, dtype=torch.int64, device=dev)
    count = 0
    for c0 in range(0, edges.shape[0], chunk):
        e = edges[c0:c0 + chunk].long()
        cu, cv = lab[e[:, 0]], lab[e[:, 1]]
        a, b = torch.minimum(cu, cv), torch.maximum(cu, cv)
        ok = (a != b) & (b < s_cap)
        if not bool(ok.any()):
            continue
        k = torch.cat([keys, a[ok] * base + b[ok]])
        w = torch.cat([wts, torch.ones(int(ok.sum()), dtype=torch.int64, device=dev)])
        uk, inv = torch.unique(k, return_inverse=True)
        uw = torch.zeros(uk.numel(), dtype=torch.int64, device=dev).index_add_(0, inv, w)
        count = int(uk.numel())
        keys, wts = uk[:cap], uw[:cap]
    m = keys.numel()
    out_a = torch.full((cap,), s_cap, dtype=torch.int64, device=dev)
    out_b = torch.full((cap,), s_cap, dtype=torch.int64, device=dev)
    out_w = torch.zeros(cap, dtype=torch.int64, device=dev)
    out_a[:m], out_b[:m], out_w[:m] = keys // base, keys % base, wts
    return out_a, out_b, out_w, count


def modularity(edges, dense_labels, dtype=torch.float64):
    """Q with the counts and every operation in ``dtype`` (the control
    takes bfloat16)."""
    e = edges.long()
    lab = dense_labels.long()
    cu, cv = lab[e[:, 0]], lab[e[:, 1]]
    k = int(lab.max()) + 1
    m = torch.tensor(float(e.shape[0]), dtype=dtype, device=e.device)
    intra = torch.bincount(cu[cu == cv], minlength=k).to(dtype)
    dcom = (torch.bincount(cu, minlength=k) + torch.bincount(cv, minlength=k)).to(dtype)
    return float(torch.sum(intra / m - (dcom / (2.0 * m)) ** 2))


def color_groups(sizes):
    """sizes [S] (integer-valued) → group [S] in 0..10."""
    s = sizes.shape[0]
    order = torch.argsort(sizes, stable=True)
    csum = torch.cumsum(sizes[order].long(), 0)
    total = int(sizes.long().sum())
    bulk = 2 * csum <= total
    n_bulk = int(bulk.sum())
    rank = torch.arange(s, device=sizes.device)
    rest = 1 + torch.div((rank - n_bulk) * 10, max(s - n_bulk, 1), rounding_mode="floor")
    g_sorted = torch.where(bulk, 0, rest.clamp(1, 10))
    g = torch.empty(s, dtype=torch.int64, device=sizes.device)
    g[order] = g_sorted
    return torch.where(sizes > 0, g, 0)
