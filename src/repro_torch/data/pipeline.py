"""Synthetic, deterministic, host-sharded data pipelines.

Every batch is a pure function of (seed, step, shard) — the property that
makes exactly-once data consumption trivial across restarts and elastic
resizes (an elastic plan hands each host its shard slice).
Token streams follow a Zipf distribution so LM losses behave like text;
graph batches come from the generators in ``repro_torch.graph``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.generators import batched_molecules


@dataclass(frozen=True)
class LMStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch_at(self, step: int, shard: tuple[int, int] | None = None) -> dict:
        """(start,size) shard of the step's global batch, or the whole batch."""
        start, size = shard or (0, self.batch)
        rng = np.random.default_rng((self.seed, step))
        toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len))
        toks = np.clip(toks, 1, self.vocab - 1).astype(np.int32)
        mask = np.ones_like(toks, np.float32)
        mask[:, -1] = 0.0  # rolled target wraps at the last position
        return {
            "tokens": toks[start : start + size],
            "loss_mask": mask[start : start + size],
        }


@dataclass(frozen=True)
class SASRecStream:
    n_items: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int, shard: tuple[int, int] | None = None) -> dict:
        start, size = shard or (0, self.batch)
        rng = np.random.default_rng((self.seed, 7, step))
        seq = rng.zipf(1.2, size=(self.batch, self.seq_len + 1))
        seq = np.clip(seq, 1, self.n_items - 1).astype(np.int32)
        neg = rng.integers(1, self.n_items, size=(self.batch, self.seq_len)).astype(np.int32)
        return {
            "seq": seq[start : start + size, :-1],
            "pos": seq[start : start + size, 1:],
            "neg": neg[start : start + size],
        }


@dataclass(frozen=True)
class MoleculeStream:
    batch: int
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 2
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, 11, step))
        edges, feats, gids = batched_molecules(
            self.batch, self.n_nodes, self.n_edges, self.d_feat,
            seed=int(rng.integers(0, 2**31)),
        )
        labels = rng.integers(0, self.n_classes, self.batch).astype(np.int32)
        return {
            "feats": feats,
            "edges": edges,
            "graph_ids": gids,
            "labels": labels,
            "mask": np.ones(self.batch, np.float32),
        }
