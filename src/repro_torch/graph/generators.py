"""Synthetic graph generators (host-side, numpy).

Copies of the reference package's generators, so the port draws the same
edges from the same seed without importing it. The paper's SNAP graphs are
not available offline, so synthetic stand-ins cover the same structural
regimes: planted-partition graphs (strong community structure, the regime
SCoDA is meant for), preferential-attachment graphs (heavy-tailed degrees,
the regime that stresses the degree threshold), G(n, p) and grid meshes.

Every generator returns ``edges`` as an int32 ``[E, 2]`` array of
undirected edges (each edge listed once, u != v); ``planted_partition``
also returns the planted labels.
"""
from __future__ import annotations

import numpy as np

__all__ = ["planted_partition", "powerlaw_graph", "erdos_renyi", "grid_mesh"]


def _sample_pairs_gnp(rng: np.random.Generator, n_pairs: int, p: float) -> np.ndarray:
    """Indices of successes among ``n_pairs`` Bernoulli(p) trials.

    Uses geometric skipping so cost is O(#successes), not O(n_pairs).
    """
    if p <= 0.0 or n_pairs <= 0:
        return np.empty(0, dtype=np.int64)
    if p >= 1.0:
        return np.arange(n_pairs, dtype=np.int64)
    # Expected successes + slack.
    exp = int(n_pairs * p)
    cap = exp + 10 + int(4 * np.sqrt(exp + 1))
    out = []
    idx = -1
    remaining = cap
    while True:
        # Draw a batch of geometric skips.
        k = max(remaining, 16)
        skips = rng.geometric(p, size=k)
        pos = idx + np.cumsum(skips)
        take = pos[pos < n_pairs]
        out.append(take)
        if len(take) < len(pos):
            break
        idx = int(pos[-1])
        remaining = max(16, remaining - len(take))
    if out:
        return np.concatenate(out)
    return np.empty(0, dtype=np.int64)


def _pair_from_index(idx: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Map linear index over the strict upper triangle of an n×n matrix to (i, j)."""
    # Row i starts at offset i*n - i*(i+1)/2 - ... solve via quadratic formula.
    idx = idx.astype(np.float64)
    b = 2 * n - 1
    i = np.floor((b - np.sqrt(b * b - 8 * idx)) / 2).astype(np.int64)
    row_start = i * n - (i * (i + 1)) // 2 - i  # start of row i in strict upper tri
    # Recompute exactly in integer domain to fix fp error at boundaries.
    idx = idx.astype(np.int64)
    while True:
        row_start = i * (2 * n - i - 1) // 2
        bad_hi = idx >= (i + 1) * (2 * n - i - 2) // 2
        bad_lo = idx < row_start
        if not (bad_hi.any() or bad_lo.any()):
            break
        i = i + bad_hi.astype(np.int64) - bad_lo.astype(np.int64)
    j = idx - row_start + i + 1
    return i, j


def erdos_renyi(n: int, p: float, seed: int = 0) -> np.ndarray:
    """G(n, p) with edges sampled by geometric skipping."""
    rng = np.random.default_rng(seed)
    n_pairs = n * (n - 1) // 2
    idx = _sample_pairs_gnp(rng, n_pairs, p)
    i, j = _pair_from_index(idx, n)
    return np.stack([i, j], axis=1).astype(np.int32)


def planted_partition(
    n: int,
    n_communities: int,
    p_in: float,
    p_out: float,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Planted-partition (SBM) graph. Returns (edges [E,2] int32, labels [n] int32)."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_communities, n // n_communities, dtype=np.int64)
    sizes[: n % n_communities] += 1
    starts = np.concatenate([[0], np.cumsum(sizes)])
    labels = np.repeat(np.arange(n_communities), sizes).astype(np.int32)

    chunks = []
    # Intra-community edges.
    for c in range(n_communities):
        s, nc = starts[c], int(sizes[c])
        n_pairs = nc * (nc - 1) // 2
        idx = _sample_pairs_gnp(rng, n_pairs, p_in)
        if len(idx):
            i, j = _pair_from_index(idx, nc)
            chunks.append(np.stack([i + s, j + s], axis=1))
    # Inter-community edges: sample per block pair (c1 < c2), a bipartite grid.
    for c1 in range(n_communities):
        for c2 in range(c1 + 1, n_communities):
            n1, n2 = int(sizes[c1]), int(sizes[c2])
            idx = _sample_pairs_gnp(rng, n1 * n2, p_out)
            if len(idx):
                i = idx // n2 + starts[c1]
                j = idx % n2 + starts[c2]
                chunks.append(np.stack([i, j], axis=1))
    if chunks:
        edges = np.concatenate(chunks).astype(np.int32)
    else:
        edges = np.empty((0, 2), dtype=np.int32)
    rng.shuffle(edges)  # streaming order matters for SCoDA; randomize like the paper
    return edges, labels


def powerlaw_graph(n: int, m: int = 4, seed: int = 0) -> np.ndarray:
    """Barabási–Albert preferential attachment; heavy-tailed degrees.

    New node t attaches to m targets sampled from the repeated-endpoints
    list (the classic O(E) construction).
    """
    rng = np.random.default_rng(seed)
    m = max(1, min(m, n - 1))
    # Seed clique on m+1 nodes.
    src0, dst0 = np.triu_indices(m + 1, k=1)
    edges = [np.stack([src0, dst0], axis=1)]
    rep = np.concatenate([src0, dst0]).astype(np.int64)
    for t in range(m + 1, n):
        targets = rng.choice(rep, size=2 * m)
        targets = np.unique(targets)[:m]
        e = np.stack([np.full(len(targets), t, dtype=np.int64), targets], axis=1)
        edges.append(e)
        rep = np.concatenate([rep, targets, np.full(len(targets), t, dtype=np.int64)])
    out = np.concatenate(edges).astype(np.int32)
    rng.shuffle(out)
    return out


def grid_mesh(nx: int, ny: int) -> np.ndarray:
    """4-connected nx × ny grid mesh. Returns edges [E,2]."""
    idx = np.arange(nx * ny).reshape(nx, ny)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([right, down]).astype(np.int32)


def batched_molecules(
    batch: int, n_nodes: int, n_edges: int, d_feat: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batch of random small graphs packed into one disjoint union.

    Returns (edges [batch*n_edges, 2], feats [batch*n_nodes, d_feat],
    graph_ids [batch*n_nodes]).
    """
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=(batch, n_edges))
    dst = (src + 1 + rng.integers(0, n_nodes - 1, size=(batch, n_edges))) % n_nodes
    offset = (np.arange(batch) * n_nodes)[:, None]
    edges = np.stack([(src + offset).ravel(), (dst + offset).ravel()], axis=1)
    feats = rng.standard_normal((batch * n_nodes, d_feat)).astype(np.float32)
    graph_ids = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    return edges.astype(np.int32), feats, graph_ids
