"""Graph padding / degree utilities."""
from __future__ import annotations

import numpy as np
import torch

def pad_edges(edges: np.ndarray, capacity: int, n_nodes: int) -> np.ndarray:
    """Pad an [E,2] edge list to [capacity,2]; padded slots point at the trash
    node ``n_nodes`` (arrays indexed by nodes are sized n_nodes+1)."""
    e = len(edges)
    if e > capacity:
        raise ValueError(f"edge count {e} exceeds capacity {capacity}")
    out = np.full((capacity, 2), n_nodes, dtype=np.int32)
    out[:e] = edges
    return out


def sanitize_edges(edges: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Route node ids outside [0, n_nodes] to the trash node ``n_nodes``.

    Every gather and scatter downstream indexes [n_nodes+1] arrays; a torch
    index out of range raises (CPU) or asserts (CUDA), so ids are masked
    once, where edges enter the device, and such edges are dropped.
    """
    bad = (edges < 0) | (edges > n_nodes)
    return torch.where(bad, n_nodes, edges)


def degrees(edges: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Node degrees from an undirected padded edge list ([E,2], trash=n_nodes)."""
    e = sanitize_edges(edges, n_nodes).long()
    one = torch.ones(e.shape[0], dtype=torch.int32, device=e.device)
    deg = torch.zeros(n_nodes + 1, dtype=torch.int32, device=e.device)
    deg.index_add_(0, e[:, 0], one)
    deg.index_add_(0, e[:, 1], one)
    return deg[:n_nodes]


def mode_degree(edges: np.ndarray, n_nodes: int) -> int:
    """The paper's default degree threshold: the most common nonzero degree."""
    deg = np.bincount(np.asarray(edges).reshape(-1), minlength=n_nodes + 1)
    deg = deg[:n_nodes]
    deg = deg[deg > 0]
    if len(deg) == 0:
        return 1
    counts = np.bincount(deg)
    counts[0] = 0
    return int(np.argmax(counts))


def to_csr(edges: np.ndarray, n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetrized CSR (indptr, indices) from an undirected edge list."""
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst.astype(np.int32)
