"""Community-size coloring (paper §4.3).

11 qualitative buckets: the *smaller* communities that together account for
50% of total size α share the first color (brown); the remaining
communities are split into 10 equal-count groups colored small→big:
brown, light purple, purple, light orange, orange, light red, red,
light green, green, light blue, blue.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# ColorBrewer-flavoured qualitative scale, small → big (RGB, 0-255).
PALETTE = np.array(
    [
        [140, 86, 75],  # brown (bulk of small communities)
        [197, 176, 213],  # light purple
        [148, 103, 189],  # purple
        [255, 187, 120],  # light orange
        [255, 127, 14],  # orange
        [255, 152, 150],  # light red
        [214, 39, 40],  # red
        [152, 223, 138],  # light green
        [44, 160, 44],  # green
        [174, 199, 232],  # light blue
        [31, 119, 180],  # blue
    ],
    dtype=np.uint8,
)


def color_groups(sizes):
    """[S] sizes → [S] int32 color-group index in [0, 11). Zero-size slots → 0.

    The ascending sort is stable: many sizes tie, and ties keep index order.
    """
    s = sizes.shape[0]
    order = torch.argsort(sizes, stable=True)  # ascending
    sorted_sizes = sizes[order]
    total = torch.sum(sizes)
    csum = torch.cumsum(sorted_sizes, 0)
    # Communities in the lower 50% of cumulative mass → group 0 (brown).
    in_bulk = csum <= 0.5 * total
    n_bulk = in_bulk.sum()
    # Remaining communities → 10 equal-count groups by rank.
    rank = torch.arange(s, device=sizes.device)
    n_rest = torch.clamp(s - n_bulk, min=1)
    group_rest = 1 + torch.div((rank - n_bulk) * 10, n_rest, rounding_mode="floor")
    group_sorted = torch.where(in_bulk, 0, torch.clamp(group_rest, 1, 10))
    groups = torch.empty(s, dtype=torch.int32, device=sizes.device)
    groups[order] = group_sorted.to(torch.int32)
    return torch.where(sizes > 0, groups, 0)


def node_colors(groups: np.ndarray) -> np.ndarray:
    """Group indices → RGB."""
    return PALETTE[np.asarray(groups)]


def write_svg(path: str, pos: np.ndarray, radii: np.ndarray, groups: np.ndarray,
              edges: np.ndarray | None = None, max_nodes: int = 200_000,
              device=None) -> str:
    """Minimal SVG renderer.

    The per-element Python string loop only scales to small graphs; inputs
    beyond ``max_nodes`` delegate to the streaming rasterizer (on
    ``device``, None = CUDA) and write a PNG next to ``path`` instead.
    Returns the path actually written.
    """
    pos = np.asarray(pos)
    radii = np.asarray(radii)
    groups = np.asarray(groups)
    if len(pos) > max_nodes:
        # Local import: repro_torch.render pulls PALETTE from this module.
        from repro_torch.render.png import write_png
        from repro_torch.render.raster import render_arrays

        out = str(Path(path).with_suffix(".png"))
        image, _stats = render_arrays(pos, radii, groups, edges, device=device)
        return write_png(out, image)
    colors = node_colors(groups)
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    size = 1024.0
    xy = (pos - lo) / span * size
    # SVG y grows downward; world y grows upward — flip so the drawing is
    # not mirrored about the horizontal axis.
    xy[:, 1] = size - xy[:, 1]
    rr = radii / span.max() * size
    rr = np.clip(rr, 0.5, size / 8)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{int(size)}" height="{int(size)}">']
    if edges is not None:
        for u, v in np.asarray(edges):
            if u < len(xy) and v < len(xy):
                parts.append(
                    f'<line x1="{xy[u,0]:.1f}" y1="{xy[u,1]:.1f}" '
                    f'x2="{xy[v,0]:.1f}" y2="{xy[v,1]:.1f}" '
                    'stroke="#cccccc" stroke-width="0.3"/>'
                )
    for (x, y), r, (cr, cg, cb) in zip(xy, rr, colors):
        parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r:.1f}" '
            f'fill="rgb({cr},{cg},{cb})" fill-opacity="0.8"/>'
        )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return str(path)
