"""What the units of work share: a fingerprint of their outputs, the
layout's seed and size, and the gaps by which outputs are compared with
the reference's."""
from __future__ import annotations

import hashlib

import numpy as np


def digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def layout_seed(seed: int) -> int:
    return int(seed) & 0xFFFFFFFF


def live_layout_size(n_live: int, s_cap: int) -> int:
    """The supergraph layout's node count: the live supernodes padded to a
    power of two, at least 64, at most ``s_cap``."""
    s = 1 << (max(n_live, 2) - 1).bit_length()
    return min(max(s, 64), s_cap)


def shape_gap(got, want, a, b, w) -> float:
    """The larger relative gap of the layout's radius of gyration and of its
    mean edge length weighted by the superedges' counts."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    w = np.asarray(w, np.float64)

    def rg(x):
        return float(np.sqrt(((x - x.mean(0)) ** 2).sum(1).mean()))

    def el(x):
        return float((w * np.linalg.norm(x[a] - x[b], axis=1)).sum() / max(w.sum(), 1.0))

    return max(abs(rg(got) / rg(want) - 1.0), abs(el(got) / max(el(want), 1e-30) - 1.0))


def position_gap(got, want) -> float:
    """Median over nodes of |Δp| over the reference's largest |p|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.median(np.linalg.norm(got - want, axis=1)) / scale)


# Iterations of the full layout's trace whose sums ``trace_gap`` compares.
TRACE_ROWS = 5


def trace_gap(got, want, rows: int) -> float:
    """Largest relative gap of Σm·swing and Σm·traction over the first
    ``rows`` iterations."""
    g = np.asarray(got, np.float64)[:rows, :2]
    w = np.asarray(want, np.float64)[:rows, :2]
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
