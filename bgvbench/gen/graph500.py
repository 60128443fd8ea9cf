"""The Graph 500 benchmark's Kronecker generator (specification, section
"Graph Generation"; its reference code ``kronecker_generator``): ``SCALE``
bits a vertex id, ``edgefactor``·2^SCALE edge draws, each bit pair drawn
from the initiator (A, B, C, D = 1 − A − B − C); then the vertex labels
are permuted and the edge list shuffled, as the specification's code does.

The picture and the layout take a simple undirected graph, so self-loops
and repeated pairs are dropped (the first draw of a pair is kept, in the
shuffled order). One NumPy generator for the seed draws it all."""
from __future__ import annotations

import numpy as np


def generate(graph: dict, seed: int) -> np.ndarray:
    scale, edgefactor = int(graph["scale"]), int(graph["edgefactor"])
    a, b, c = float(graph["A"]), float(graph["B"]), float(graph["C"])
    n, m = 1 << scale, edgefactor << scale
    rng = np.random.default_rng(seed)
    ab = a + b
    c_norm, a_norm = np.float32(c / (1.0 - ab)), np.float32(a / ab)
    i = np.zeros(m, np.int32)
    j = np.zeros(m, np.int32)
    for bit in range(scale):
        ii = rng.random(m, dtype=np.float32) > np.float32(ab)
        jj = rng.random(m, dtype=np.float32) > np.where(ii, c_norm, a_norm)
        i |= ii.astype(np.int32) << bit
        j |= jj.astype(np.int32) << bit
    label = rng.permutation(n).astype(np.int32)
    i, j = label[i], label[j]
    order = rng.permutation(m)
    i, j = i[order], j[order]
    keep = i != j
    i, j = i[keep], j[keep]
    key = np.minimum(i, j).astype(np.int64) * n + np.maximum(i, j)
    _, first = np.unique(key, return_index=True)
    first.sort()
    return np.stack([i[first], j[first]], axis=1)


def nodes(graph: dict) -> int:
    """Vertex count: 2^SCALE, isolated vertices included."""
    return 1 << int(graph["scale"])
