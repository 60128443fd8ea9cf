"""Layout-quality metrics that scale: sampling, not all-pairs.

The port's own copy of the reference's quality harness: the same numpy
code, with the spatial candidates of ``neighborhood_preservation`` binned
by the port's ``kernels/grid`` ``bin_and_sort`` on CPU tensors (bitwise the
reference's cell ids and stable order), so every metric returns the
reference's floats for the same layout.

Every classical layout metric (stress, neighborhood preservation,
crossings) is O(n²) or worse when computed exactly — useless at the
paper's millions of nodes. This module keeps each one subquadratic:

  * ``sampled_stress`` — pivot-based normalized stress: P BFS passes give
    graph distances from P pivots to everyone (O(P·E)), a closed-form
    optimal scale α aligns the layout to those distances, and the result
    is the mean squared relative error in [0, 1] (0 = distances perfectly
    realized, 1 = what the degenerate all-points-coincident layout gets).
  * ``neighborhood_preservation`` — for S sampled nodes: the k-ring graph
    neighborhood (≤ ``ring`` hops, capped at ``k_cap``) vs the spatial
    k-nearest neighbors of the layout, where the spatial candidates come
    from the same uniform-grid binning FA2's repulsion uses
    (kernels/grid ``bin_and_sort``): candidates are a ±``band`` window in
    cell-sorted order — locality-approximate, but identical across the
    layouts being compared, which is what a ratio gate needs. Returns the
    mean Jaccard-style overlap |graph ∩ spatial-kNN| / k in [0, 1].
  * ``edge_length_cv`` — coefficient of variation of edge lengths (lower
    = more uniform; aesthetic-uniformity proxy).
  * ``crossing_proxy`` — fraction of sampled edge pairs (disjoint
    endpoints) whose segments properly intersect; an unbiased estimate of
    crossing density at O(samples) cost.

All functions take host numpy arrays: ``pos`` [n, 2] float, ``edges``
[e, 2] int int (unpadded — no trash endpoints). Sampling is seeded and
deterministic; comparisons must reuse one seed across layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.grid.ref import bin_and_sort


def _csr(edges: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Undirected CSR adjacency (indptr [n+1], indices [2e]), self-loops
    and duplicate edges kept as given (they only re-weight neighbors)."""
    edges = np.asarray(edges, np.int64)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst.astype(np.int32)


def _frontier_neighbors(indptr, indices, frontier):
    """All neighbors (with multiplicity) of the frontier nodes, vectorized."""
    counts = indptr[frontier + 1] - indptr[frontier]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int32)
    starts = np.repeat(indptr[frontier], counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    return indices[starts + offs]


def bfs_hops(
    indptr: np.ndarray,
    indices: np.ndarray,
    source: int,
    n: int,
    max_hops: int | None = None,
) -> np.ndarray:
    """Hop distances from ``source`` ([n] int32, −1 = unreached), breadth
    first over the CSR adjacency; stops after ``max_hops`` levels."""
    dist = np.full(n, -1, np.int32)
    dist[source] = 0
    frontier = np.array([source], np.int64)
    d = 0
    while frontier.size and (max_hops is None or d < max_hops):
        d += 1
        nbr = _frontier_neighbors(indptr, indices, frontier)
        nbr = nbr[dist[nbr] < 0]
        if nbr.size == 0:
            break
        frontier = np.unique(nbr).astype(np.int64)
        dist[frontier] = d
    return dist


def sampled_stress(
    pos: np.ndarray,
    edges: np.ndarray,
    n: int,
    n_pivots: int = 16,
    seed: int = 0,
) -> float:
    """Pivot-sampled normalized stress in [0, 1] (lower is better).

    With graph distances δ from ``n_pivots`` BFS sources and layout
    distances e, the scale-optimal α = Σ(e/δ) / Σ(e²/δ²) minimizes
    Σ (αe − δ)²/δ², and the minimum divided by the pair count is the
    reported stress (δ-weighting makes it scale-free; α makes it
    invariant to the layout's arbitrary global scale).
    """
    pos = np.asarray(pos, np.float64)
    indptr, indices = _csr(edges, n)
    rng = np.random.default_rng(seed)
    pivots = rng.choice(n, size=min(n_pivots, n), replace=False)
    num = den = sq = 0.0
    count = 0
    for p in pivots:
        dist = bfs_hops(indptr, indices, int(p), n)
        reach = np.nonzero(dist > 0)[0]
        if reach.size == 0:
            continue
        delta = dist[reach].astype(np.float64)
        e = np.linalg.norm(pos[reach] - pos[int(p)], axis=1)
        num += float(np.sum(e / delta))
        den += float(np.sum((e / delta) ** 2))
        count += reach.size
    if count == 0 or den == 0.0:
        return 0.0
    alpha = num / den
    # Σ((αe − δ)/δ)² = α²·den − 2α·num + count, evaluated at the optimum.
    total = alpha * alpha * den - 2.0 * alpha * num + count
    return float(total / count)


def neighborhood_preservation(
    pos: np.ndarray,
    edges: np.ndarray,
    n: int,
    n_samples: int = 256,
    ring: int = 1,
    k_cap: int = 20,
    grid_size: int | None = None,
    band: int = 128,
    seed: int = 0,
) -> float:
    """Mean overlap between k-ring graph neighborhoods and spatial k-NN.

    For each sampled node i with graph neighborhood N_g(i) (nodes ≤
    ``ring`` hops away, truncated to the ``k_cap`` nearest-in-layout
    would bias toward the layout, so truncation is arbitrary-but-fixed:
    the first ``k_cap`` in node-id order), k = |N_g(i)|; the spatial side
    takes the k nearest layout neighbors of i among a ±``band`` window in
    kernels/grid cell-sorted order (the same binning FA2 repulsion uses).
    Scores |N_g ∩ kNN| / k, averaged over samples with k ≥ 1.

    ``grid_size=None`` sizes the grid so one cell holds ~64 nodes: the
    band window walks consecutive cell ids (one grid *column* strip), so
    cells must be coarse enough that a node's true spatial neighbors sit
    in its own/adjacent cells rather than in adjacent columns the strip
    never reaches.
    """
    if grid_size is None:
        grid_size = max(4, int(np.sqrt(n / 64.0)))

    pos = np.asarray(pos, np.float64)
    indptr, indices = _csr(edges, n)
    rng = np.random.default_rng(seed)
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    eligible = np.nonzero(deg > 0)[0]
    if eligible.size == 0:
        return 0.0
    samples = rng.choice(
        eligible, size=min(n_samples, eligible.size), replace=False
    )

    _, order = bin_and_sort(torch.as_tensor(np.asarray(pos, np.float32)), grid_size)
    order = order.numpy()
    rank = np.zeros(n, np.int64)
    rank[order] = np.arange(n)

    scores = []
    for i in samples:
        i = int(i)
        if ring == 1:
            nbrs = np.unique(indices[indptr[i]:indptr[i + 1]])
        else:
            dist = bfs_hops(indptr, indices, i, n, max_hops=ring)
            nbrs = np.nonzero(dist > 0)[0]
        nbrs = nbrs[nbrs != i][:k_cap]
        k = nbrs.size
        if k == 0:
            continue
        p = rank[i]
        lo, hi = max(0, p - band), min(n, p + band + 1)
        cand = order[lo:hi]
        cand = cand[cand != i]
        if cand.size == 0:
            scores.append(0.0)
            continue
        d = np.linalg.norm(pos[cand] - pos[i], axis=1)
        kk = min(k, cand.size)
        near = cand[np.argpartition(d, kk - 1)[:kk]]
        scores.append(np.intersect1d(near, nbrs).size / k)
    return float(np.mean(scores)) if scores else 0.0


def edge_length_cv(pos: np.ndarray, edges: np.ndarray) -> float:
    """Coefficient of variation (σ/μ) of edge lengths; 0 = all equal."""
    edges = np.asarray(edges, np.int64)
    if len(edges) == 0:
        return 0.0
    pos = np.asarray(pos, np.float64)
    lengths = np.linalg.norm(pos[edges[:, 0]] - pos[edges[:, 1]], axis=1)
    mean = float(lengths.mean())
    if mean == 0.0:
        return 0.0
    return float(lengths.std() / mean)


def crossing_proxy(
    pos: np.ndarray,
    edges: np.ndarray,
    n_pairs: int = 4096,
    seed: int = 0,
) -> float:
    """Fraction of sampled endpoint-disjoint edge pairs that properly
    cross (strict segment intersection, shared endpoints excluded)."""
    edges = np.asarray(edges, np.int64)
    e = len(edges)
    if e < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    a = rng.integers(0, e, size=n_pairs)
    b = rng.integers(0, e, size=n_pairs)
    ok = a != b
    ea, eb = edges[a], edges[b]
    # Endpoint-disjoint pairs only: shared endpoints touch, never cross.
    for i in range(2):
        for j in range(2):
            ok &= ea[:, i] != eb[:, j]
    if not ok.any():
        return 0.0
    ea, eb = ea[ok], eb[ok]
    pos = np.asarray(pos, np.float64)
    p, q = pos[ea[:, 0]], pos[ea[:, 1]]
    r, s = pos[eb[:, 0]], pos[eb[:, 1]]

    def orient(o, x, y):
        return (x[:, 0] - o[:, 0]) * (y[:, 1] - o[:, 1]) - (
            x[:, 1] - o[:, 1]
        ) * (y[:, 0] - o[:, 0])

    d1, d2 = orient(p, q, r), orient(p, q, s)
    d3, d4 = orient(r, s, p), orient(r, s, q)
    cross = (d1 * d2 < 0) & (d3 * d4 < 0)
    return float(cross.mean())


def layout_quality(
    pos: np.ndarray,
    edges: np.ndarray,
    n: int,
    seed: int = 0,
    n_pivots: int = 16,
    n_samples: int = 256,
    ring: int = 1,
) -> dict:
    """All four metrics under one seed, as one record."""
    return {
        "stress": sampled_stress(pos, edges, n, n_pivots=n_pivots, seed=seed),
        "neighborhood": neighborhood_preservation(
            pos, edges, n, n_samples=n_samples, ring=ring, seed=seed
        ),
        "edge_cv": edge_length_cv(pos, edges),
        "crossing": crossing_proxy(pos, edges, seed=seed),
    }
