"""Host-side CSR fanout neighbor sampler (GraphSAGE-style).

``minibatch_lg`` (232k nodes / 114M edges, batch_nodes=1024, fanout 15-10)
requires a *real* neighbor sampler: this one samples k-hop neighborhoods
from CSR with per-hop fanouts and emits a padded, statically-shaped
subgraph ready for a fixed-shape train step.

The sampler runs on host (numpy) — it is the data-pipeline stage; the
padded subgraph tensors are what the device step consumes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SampledSubgraph:
    """Padded, statically-shaped subgraph.

    nodes:    [max_nodes] int32 global node ids (padded with -1)
    edges:    [max_edges, 2] int32 *local* indices into ``nodes``
              (padded slots point at ``max_nodes`` trash slot)
    n_nodes:  int, valid node count
    n_edges:  int, valid edge count
    seed_mask:[max_nodes] bool, True for the seed (loss) nodes
    """

    nodes: np.ndarray
    edges: np.ndarray
    n_nodes: int
    n_edges: int
    seed_mask: np.ndarray


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray, fanouts: tuple[int, ...]):
        self.indptr = indptr
        self.indices = indices
        self.fanouts = tuple(fanouts)

    def max_capacity(self, batch_nodes: int) -> tuple[int, int]:
        """Static (max_nodes, max_edges) for a given seed-batch size."""
        n, e = batch_nodes, 0
        frontier = batch_nodes
        for f in self.fanouts:
            frontier = frontier * f
            n += frontier
            e += frontier
        return n, e

    def sample(self, seeds: np.ndarray, rng: np.random.Generator) -> SampledSubgraph:
        seeds = np.unique(seeds)  # duplicate seeds would corrupt the relabel
        batch = len(seeds)
        max_nodes, max_edges = self.max_capacity(batch)
        src_chunks, dst_chunks = [], []
        frontier = seeds.astype(np.int64)
        for f in self.fanouts:
            starts = self.indptr[frontier]
            degs = self.indptr[frontier + 1] - starts
            # Sample ``f`` neighbors with replacement per frontier node (skip deg-0).
            pick = rng.integers(0, np.maximum(degs, 1)[:, None], size=(len(frontier), f))
            neigh = self.indices[starts[:, None] + pick]
            valid = np.broadcast_to(degs[:, None] > 0, (len(frontier), f))
            src = np.repeat(frontier, f).reshape(len(frontier), f)
            src_chunks.append(src[valid])
            dst_chunks.append(neigh[valid])
            frontier = np.unique(neigh[valid])
        src = np.concatenate(src_chunks)
        dst = np.concatenate(dst_chunks)
        # Global → local relabel; seeds first so the loss mask is trivial.
        uniq, inverse = np.unique(np.concatenate([seeds, src, dst]), return_inverse=True)
        # Ensure seeds occupy the first slots: build a permutation.
        seed_pos = np.searchsorted(uniq, seeds)
        perm = np.full(len(uniq), -1, dtype=np.int64)
        perm[seed_pos] = np.arange(len(seeds))
        rest = np.setdiff1d(np.arange(len(uniq)), seed_pos, assume_unique=False)
        perm[rest] = np.arange(len(seeds), len(uniq))
        local = perm[inverse]
        lsrc = local[len(seeds) : len(seeds) + len(src)]
        ldst = local[len(seeds) + len(src) :]

        nodes = np.full(max_nodes, -1, dtype=np.int32)
        order = np.empty(len(uniq), dtype=np.int64)
        order[perm] = np.arange(len(uniq))
        nodes[: len(uniq)] = uniq[order]
        edges = np.full((max_edges, 2), max_nodes, dtype=np.int32)
        edges[: len(src), 0] = lsrc
        edges[: len(src), 1] = ldst
        seed_mask = np.zeros(max_nodes, dtype=bool)
        seed_mask[: len(seeds)] = True
        return SampledSubgraph(
            nodes=nodes,
            edges=edges,
            n_nodes=len(uniq),
            n_edges=len(src),
            seed_mask=seed_mask,
        )
