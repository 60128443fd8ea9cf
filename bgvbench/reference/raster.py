"""The supergraph picture (paper §4.3) from positions, sizes, colour groups
and weighted superedges.

The scene is fitted into the image with a 4 % margin (uniform scale, y
up), as pixel coordinates computed in NumPy. A node is a disk of radius
``√size`` (clipped to [1, H/8] pixels): pixel (x, y) counts for the disk's
colour group where ``(y − cy)² + (x − cx)² ≤ r²`` in float32. An edge is 8
samples at ``t = (k + ½)/8`` along the segment, each counted for the group
of its nearer endpoint, ``clip(round(w), 1, 2^20)`` times; samples off the
image drop. A layer's counts become intensities ``log1p(gain·count)``
(gain 1 for edges, 4 for nodes), blended over the 11-colour palette and
composited with opacity ``1 − e^{−Σ}`` (edges at 0.85 of it, under the
nodes) over white, then rounded to bytes.
"""
from __future__ import annotations

import numpy as np
import torch

PALETTE = np.array(
    [[140, 86, 75], [197, 176, 213], [148, 103, 189], [255, 187, 120], [255, 127, 14],
     [255, 152, 150], [214, 39, 40], [152, 223, 138], [44, 160, 44], [174, 199, 232],
     [31, 119, 180]], dtype=np.uint8)


def _floor_px(x):
    x = torch.nan_to_num(torch.floor(x), nan=0.0)
    return torch.clamp(x, -(2.0**30), 2.0**30).long()


def _disks(acc, px, py, r, grp, chunk: int = 4096):
    """Count the disks' pixels into acc [G, H, W] (int64)."""
    g_n, h, w = acc.shape
    flat = acc.view(-1)
    rad = torch.ceil(r).long()
    order = torch.argsort(rad)
    px, py, r, grp, rad = px[order], py[order], r[order], grp[order], rad[order]
    for i0 in range(0, px.numel(), chunk):
        sl = slice(i0, i0 + chunk)
        half = int(rad[sl].max()) + 2
        d = torch.arange(-half, half + 1, device=acc.device)
        xs = _floor_px(px[sl])[:, None] + d[None, :]
        ys = _floor_px(py[sl])[:, None] + d[None, :]
        dx = xs.float() - px[sl, None]
        dy = ys.float() - py[sl, None]
        rr = (r[sl] * r[sl])[:, None, None]
        inside = (dy * dy)[:, :, None] + (dx * dx)[:, None, :] <= rr
        inside &= ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
        idx = (grp[sl, None, None] * h + ys[:, :, None]) * w + xs[:, None, :]
        flat.index_add_(0, idx[inside], torch.ones_like(idx[inside]))


def picture(pos, sizes, groups, sa, sb, sw, *, width: int = 1024, height: int = 1024,
            samples: int = 8, device="cpu"):
    """→ image [H, W, 3] uint8 (host). pos [S, 2] float32, sizes [S],
    groups [S], superedges (sa, sb, sw) with padding ids ≥ S (host arrays)."""
    pos = np.asarray(pos, np.float32)
    radii = np.sqrt(np.maximum(np.asarray(sizes, np.float32), 0.0)).astype(np.float32)
    groups = np.asarray(groups, np.int64)
    n = len(pos)
    hs, ws = height, width
    g_n = len(PALETTE)
    alive = radii > 0
    src = pos[alive] if alive.any() else pos
    lo, hi = src.min(axis=0), src.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = float((1.0 - 2.0 * 0.04) * min(ws / span[0], hs / span[1]))
    center = (lo + hi) / 2.0
    ox, oy = float(center[0]), float(center[1])
    px = (pos[:, 0] - ox) * scale + ws / 2.0
    py = hs / 2.0 - (pos[:, 1] - oy) * scale
    r_px = np.where(alive, np.clip(radii * scale, 1.0, 0.125 * min(hs, ws)),
                    0.0).astype(np.float32)

    def dev(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    nodes = torch.zeros((g_n, hs, ws), dtype=torch.int64, device=device)
    keep = (r_px > 0) & (groups >= 0) & (groups < g_n)
    _disks(nodes, dev(px[keep], torch.float32), dev(py[keep], torch.float32),
           dev(r_px[keep], torch.float32), dev(groups[keep], torch.int64))

    edges = torch.zeros(g_n * hs * ws, dtype=torch.int64, device=device)
    pxy = dev(np.stack([px, py], 1).astype(np.float32), torch.float32)
    gr = dev(groups, torch.int64)
    a, b = dev(sa, torch.int64), dev(sb, torch.int64)
    ok = (a >= 0) & (a < n) & (b >= 0) & (b < n)
    a, b = a[ok], b[ok]
    inc = dev(np.clip(np.round(np.asarray(sw, np.float64)), 1, 1 << 20), torch.int64)[ok]
    pu, pv = pxy[a], pxy[b]
    t = (torch.arange(samples, dtype=torch.float32, device=device) + 0.5) / samples
    p = pu[:, None, :] + t[None, :, None] * (pv - pu)[:, None, :]
    ix, iy = _floor_px(p[..., 0]), _floor_px(p[..., 1])
    g = torch.where(t[None, :] < 0.5, gr[a][:, None], gr[b][:, None])
    on = (g >= 0) & (g < g_n) & (ix >= 0) & (ix < ws) & (iy >= 0) & (iy < hs)
    idx = (g * hs + iy) * ws + ix
    edges.index_add_(0, idx[on], inc[:, None].expand(idx.shape)[on])
    edges = edges.view(g_n, hs, ws)

    pal = torch.as_tensor(PALETTE, dtype=torch.float32, device=device)
    img = torch.full((hs, ws, 3), 255.0, device=device)
    for acc, gain, top in ((edges, 1.0, 0.85), (nodes, 4.0, 1.0)):
        i = torch.log1p(gain * acc.to(torch.float32))
        tot = torch.sum(i, 0)
        rgb = torch.einsum("ghw,gc->hwc", i, pal) / torch.clamp(tot, min=1e-9)[..., None]
        alpha = (top * (1.0 - torch.exp(-tot)))[..., None]
        img = alpha * rgb + (1.0 - alpha) * img
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8).cpu().numpy()
