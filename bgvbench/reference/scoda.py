"""Streaming community detection (SCoDA, paper §3.2.1) in blocks.

The edge list, padded with the trash node ``n`` to whole blocks, is read
``rounds`` times. Round ``i`` admits an edge when both endpoints' degrees,
counted as in a sequential stream (the degree at the block's start plus
one, plus the endpoint's earlier occurrences in the block), are at most
``δ^(i+1)`` (capped at 2^30); of the two, the endpoint of the smaller
degree joins the community of the other, and an edge of equal degrees is
skipped. Within a block every edge reads the state at the block's start;
where several edges move one node, the donor of the highest degree wins
and then the smallest community id. Both endpoints' degrees grow by one
for every valid edge.
"""
from __future__ import annotations

import torch

_BIG = 2**31 - 1


def thresholds(delta: int, rounds: int) -> list[int]:
    return [int(min(float(delta) ** (i + 1), 2**30)) for i in range(rounds)]


def _prior_counts(u, v, valid):
    """For each edge, how often each endpoint occurred earlier in the block
    (as u or v, in stream order u0, v0, u1, v1, ...)."""
    flat = torch.stack([u, v], 1).reshape(-1)
    key = flat * flat.numel() + torch.arange(flat.numel(), device=flat.device)
    order = torch.argsort(key)
    s = flat[order]
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.arange(s.numel(), device=s.device)
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    rank = rank.reshape(-1, 2) * valid[:, None]
    return rank[:, 0], rank[:, 1]


def _block(com, deg, blk, thr: int, trash: int):
    u, v = blk[:, 0], blk[:, 1]
    valid = (u != trash) & (v != trash) & (u != v)
    pu, pv = _prior_counts(u, v, valid)
    du = deg[u] + 1 + pu
    dv = deg[v] + 1 + pv
    ok = valid & (du <= thr) & (dv <= thr)
    v_joins = ok & (du > dv)
    u_joins = ok & (dv > du)
    moves = v_joins | u_joins
    node = torch.where(v_joins, v, torch.where(u_joins, u, trash))
    donor = torch.where(v_joins, u, v)
    ddeg = torch.where(moves, torch.where(v_joins, du, dv), -1)
    best = torch.full((trash + 1,), -1, dtype=torch.int64, device=com.device)
    best.scatter_reduce_(0, node, ddeg, "amax")
    wins = moves & (ddeg == best[node])
    cand = torch.where(wins, com[donor], _BIG)
    new = torch.full((trash + 1,), _BIG, dtype=torch.int64, device=com.device)
    new.scatter_reduce_(0, node, cand, "amin")
    com = torch.where(new != _BIG, new, com)
    com[trash] = trash
    one = valid.to(torch.int64)
    deg = deg.index_add(0, u, one).index_add(0, v, one)
    deg[trash] = 0
    return com, deg


def detect(edges, n: int, delta: int, rounds: int, block: int):
    """edges [E, 2] int (device tensor) → community label per node [n],
    int64 (a node id: the community's representative)."""
    dev = edges.device
    e = edges.shape[0]
    nb = -(-e // block)
    padded = torch.full((nb * block, 2), n, dtype=torch.int64, device=dev)
    padded[:e] = edges.long()
    com = torch.arange(n + 1, dtype=torch.int64, device=dev)
    deg = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    for thr in thresholds(delta, rounds):
        for k in range(nb):
            com, deg = _block(com, deg, padded[k * block:(k + 1) * block], thr, n)
    return com[:n]
