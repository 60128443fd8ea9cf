"""Plain PyTorch versions of the uniform-grid repulsion family (kernels K5
far field and K6 near field), and the binning every backend shares.

* ``bin_nodes`` / ``bin_and_sort`` — a G×G grid over the positions' bounding
  box; cell ids are computed with the reference's unfused operations in its
  order, ``(pos − lo) / extent · G`` truncated toward zero, so they are
  bitwise equal to the reference's for the same positions. The sort is
  stable (the near-field band depends on the order of each cell's run).
* ``far_field_ref`` — chunks of ``nb`` nodes against every cell monopole as
  a dense ``[nb, C]`` block, the own cell masked inside the block.
* ``near_field_ref`` — the exact same-cell band over the cell-sorted order
  as 2W+1 shifted passes (``torch.roll`` and a mask), k = −W … W in order.
  Every operation is one rounding, so kernel K6, which rounds each step the
  same way in the same order, agrees with it bitwise.
* ``near_field_rows`` — rows ``[i0, i0 + nl)`` of ``near_field_ref`` from a
  ±W halo around the row block (the sharded layout's form); bitwise equal to
  slicing the full version.

All math is float32. Force magnitude ``kr · mᵢ · mⱼ / max(d², EPS2)`` along
the displacement, as in ``core/forceatlas2._pair_force``.
"""
from __future__ import annotations

import torch

# d² clamp of the monopole and near-field force magnitude.
EPS2 = 1e-4


def bin_nodes(pos, grid_size: int):
    """Flat G×G cell id per node ([n] int32) from the positions' bbox."""
    g = grid_size
    pos = pos.to(torch.float32)
    lo = pos.min(dim=0).values
    hi = pos.max(dim=0).values
    extent = torch.clamp(hi - lo, min=1e-6)
    cell2d = torch.clamp(((pos - lo) / extent * g).to(torch.int32), 0, g - 1)
    return cell2d[:, 0] * g + cell2d[:, 1]


def bin_and_sort(pos, grid_size: int):
    """(cell ids [n] int32, cell-sorted order [n] int32): the grid state the
    FA2 loop carries and rebuilds every ``grid_rebuild`` iterations."""
    cell = bin_nodes(pos, grid_size)
    return cell, torch.argsort(cell, stable=True).to(torch.int32)


def far_field_ref(pos, mass, cell, ccent, cmass, kr: float, nb: int = 1024):
    """Monopole far field, own cell excluded → [n, 2].

    ``pos`` [n, 2], ``mass`` [n] (padding carries mass 0), ``cell`` [n]
    int32, ``ccent`` [C, 2] centroids, ``cmass`` [C] masses (empty cell = 0,
    force-dead). O(nb·C) live memory."""
    n = pos.shape[0]
    cx = ccent[:, 0][None, :]
    cy = ccent[:, 1][None, :]
    cm = cmass[None, :]
    cells = torch.arange(ccent.shape[0], dtype=torch.int32, device=pos.device)[None, :]
    out = torch.empty((n, 2), dtype=torch.float32, device=pos.device)
    for i0 in range(0, n, nb):
        p, m, ci = pos[i0:i0 + nb], mass[i0:i0 + nb], cell[i0:i0 + nb]
        dx = p[:, 0:1] - cx
        dy = p[:, 1:2] - cy
        d2 = dx * dx + dy * dy
        mag = kr * m[:, None] * cm / torch.clamp(d2, min=EPS2)
        mag = torch.where(ci[:, None] == cells, 0.0, mag)
        out[i0:i0 + nb, 0] = (mag * dx).sum(1)
        out[i0:i0 + nb, 1] = (mag * dy).sum(1)
    return out


def _band_pass(acc, x, y, m, c, xs, ys, ms, cs, ok, kr: float):
    """acc += the masked pair forces of one shift (one rounding per op)."""
    dx = x - xs
    dy = y - ys
    d2 = dx * dx + dy * dy
    mag = torch.where(ok & (cs == c), kr * m * ms / torch.clamp(d2, min=EPS2), 0.0)
    return acc[0] + mag * dx, acc[1] + mag * dy


def near_field_ref(pos_s, mass_s, cell_s, kr: float, window: int):
    """Exact same-cell forces over a ±``window`` band of the cell-sorted
    order → [n, 2] (sorted order). Exact for cells of ≤ window members."""
    n = pos_s.shape[0]
    idx = torch.arange(n, device=pos_s.device)
    x, y = pos_s[:, 0].contiguous(), pos_s[:, 1].contiguous()
    acc = (torch.zeros_like(x), torch.zeros_like(y))
    for k in range(-window, window + 1):
        # Neighbour j = i + k through a shifted view, rolled[i] = arr[(i+k) % n];
        # the in-range mask discards the wrapped entries.
        j = idx + k
        ok = (j >= 0) & (j < n) & (k != 0)
        acc = _band_pass(acc, x, y, mass_s, cell_s,
                         torch.roll(x, -k), torch.roll(y, -k),
                         torch.roll(mass_s, -k), torch.roll(cell_s, -k), ok, kr)
    return torch.stack(acc, dim=1)


def near_field_rows(pos_s, mass_s, cell_s, kr: float, window: int, i0: int, nl: int):
    """Rows ``[i0, i0 + nl)`` of ``near_field_ref`` → [nl, 2] (sorted order).

    Neighbour values come from the ±window halo around the row block (arrays
    padded by ``window`` on each side, halo cell id −1) instead of rolling
    the full arrays; the in-range mask discards the same slots, so the rows
    are bitwise those of the full version."""
    n = pos_s.shape[0]
    w = window

    def pad(v, fill=0):
        edge = torch.full((w,), fill, dtype=v.dtype, device=v.device)
        return torch.cat([edge, v, edge])

    xp, yp = pad(pos_s[:, 0]), pad(pos_s[:, 1])
    mp, cp = pad(mass_s), pad(cell_s, fill=-1)
    lo = i0 + w
    x, y, m, c = xp[lo:lo + nl], yp[lo:lo + nl], mp[lo:lo + nl], cp[lo:lo + nl]
    gidx = i0 + torch.arange(nl, device=pos_s.device)
    acc = (torch.zeros_like(x), torch.zeros_like(y))
    for k in range(-w, w + 1):
        j = gidx + k
        ok = (j >= 0) & (j < n) & (k != 0)
        s = slice(lo + k, lo + k + nl)
        acc = _band_pass(acc, x, y, m, c, xp[s], yp[s], mp[s], cp[s], ok, kr)
    return torch.stack(acc, dim=1)
