"""Block-parallel streaming community detection (SCoDA, paper §3.2.1).

The paper's GPU variant assigns one thread per edge and lets degree updates
and community writes race through atomics. This module keeps the
deterministic block form of the reference package instead, so labels are
bit-identical to it: the edge stream is processed in fixed-size *blocks*,

  * inside a block every edge is evaluated in parallel against the
    block-start degree/community snapshot,
  * conflicting community writes to the same node are resolved by a
    deterministic scatter-min (``scatter_reduce_(..., "amin")``),
  * degree increments land via integer ``index_add_``.

``block_size`` is the parallelism/fidelity dial: block_size=1 is exactly
the sequential SCoDA. The block scan is a Python loop of torch ops; the
reference has no accelerator kernel here.

Multi-device (``sharded_scoda_update``): each rank holds the same
within-block slice of every block of a chunk (``block_chunk_spec``) and the
whole replicated state. Per block one tiled all-gather of the slices (b×2
int32, b = ``block_size``) rebuilds the block on every rank, which then
runs the single-rank block update on it. So the result is bitwise the
single-rank one, and no per-block exchange grows with n. What is split is
the chunk's reads, staging and host→device copies; the per-edge evaluation
and the scatters are replicated. The reference instead splits the per-edge
evaluation and completes each scatter with an all-reduce over the full
[n+1] state (three a block), which at n = 685,231 would move ≈ 53 GB a run
through gloo's host staging.

Rounds follow the paper's Algorithm 3: each round re-streams the edge list
with persistent (community, degree) state and a threshold that grows
geometrically (δ^i) so larger communities can keep absorbing smaller ones.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.sharding.collectives import all_gather_rows

INT32_MAX = torch.iinfo(torch.int32).max


@dataclass(frozen=True)
class ScodaConfig:
    degree_threshold: int  # δ — paper default: mode degree of the graph
    rounds: int = 4
    block_size: int = 4096
    threshold_growth: float = 2.0  # threshold at round i: δ * growth^(i-1) (δ^i capped)
    threshold_schedule: str = "paper"  # "paper": δ^i ; "geometric": δ·g^(i-1)
    tie_break: str = "skip"  # paper Algorithm 3 skips equal-degree edges
    # "scoda": both endpoint degrees bump on every processed edge (Hollocou's
    # SCoDA; the only reading that does not deadlock); "paper": adoptee++ only.
    degree_update: str = "scoda"
    compress_labels: bool = False  # pointer-jump label compression at the end
    # Each edge sees deg(snapshot) + its endpoint's prior occurrences within
    # the block — the exact sequential degree trajectory at block parallelism.
    exact_block_degrees: bool = True
    # Same-block donor conflicts: "min" = smallest community id wins;
    # "max_degree" = highest-degree donor wins (big communities absorb small).
    conflict: str = "max_degree"
    # Pointer-jumping passes at block end that collapse intra-block
    # adoption chains of length ≤ 2^jumps (0: off, the measured best).
    propagate_jumps: int = 0


def round_threshold(cfg: ScodaConfig, i: int) -> int:
    if cfg.threshold_schedule == "paper":
        t = float(cfg.degree_threshold) ** (i + 1)
    else:
        t = float(cfg.degree_threshold) * (cfg.threshold_growth ** i)
    return int(min(t, 2**30))


def _cumcount_endpoints(u, v, valid):
    """Per-edge prior-occurrence counts of each endpoint within the block.

    Flattens endpoints in stream order [u0,v0,u1,v1,...] and counts, for each
    slot, how many earlier slots name the same node — a stable sort + rank
    in group. The sort must be stable: ties keep stream order.
    """
    bs = u.shape[0]
    flat = torch.stack([u, v], dim=1).reshape(-1)  # [2B] stream order
    order = torch.argsort(flat, stable=True)
    sorted_vals = flat[order]
    is_start = torch.ones_like(sorted_vals, dtype=torch.bool)
    is_start[1:] = sorted_vals[1:] != sorted_vals[:-1]
    idx = torch.arange(2 * bs, device=u.device)
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - group_start
    rank = torch.where(valid[:, None].expand(-1, 2).reshape(-1), rank, 0)
    return rank[0::2], rank[1::2]


def _block_update(state, block, *, threshold, tie_break, degree_update,
                  exact_block_degrees, conflict, propagate_jumps, mesh=None):
    """Process one block of edges [B, 2] (trash = n) against the block-start
    snapshot; returns the new ``(com, deg)``.

    With ``mesh`` the block is this rank's slice of it (``block_chunk_spec``)
    and is gathered whole, in stream order, before anything else."""
    if mesh is not None:
        block = all_gather_rows(block, mesh)
    block = block.long()
    com, deg = state
    u, v = block[:, 0], block[:, 1]
    trash = com.shape[0] - 1  # index n_nodes = trash slot
    valid = (u != trash) & (v != trash) & (u != v)

    if degree_update == "scoda":
        if exact_block_degrees:
            cu, cv = _cumcount_endpoints(u, v, valid)
        else:
            cu = cv = 0
        du = deg[u] + 1 + cu
        dv = deg[v] + 1 + cv
    else:
        du = deg[u].long()
        dv = deg[v].long()
    elig = valid & (du <= threshold) & (dv <= threshold)

    adopt_v = elig & (du > dv)  # v adopts com[u]
    adopt_u = elig & (dv > du)  # u adopts com[v]
    if tie_break == "join":
        adopt_u = adopt_u | (elig & (du == dv))

    adoptee = torch.where(adopt_v, v, torch.where(adopt_u, u, trash))
    donor = torch.where(adopt_v, u, v)
    any_adopt = adopt_u | adopt_v
    donor_com = torch.where(any_adopt, com[donor], INT32_MAX)

    if conflict == "max_degree":
        # Highest-degree donor wins; ties go to the smaller community id.
        donor_deg = torch.where(any_adopt, torch.where(adopt_v, du, dv), -1)
        donor_deg = donor_deg.to(torch.int32)
        win_deg = torch.full_like(com, -1).scatter_reduce_(
            0, adoptee, donor_deg, "amax", include_self=True
        )
        is_winner = any_adopt & (donor_deg == win_deg[adoptee])
        cand_val = torch.where(is_winner, donor_com, INT32_MAX)
    else:  # "min": smallest donor community id wins
        cand_val = donor_com
    cand = torch.full_like(com, INT32_MAX).scatter_reduce_(
        0, adoptee, cand_val, "amin", include_self=True
    )
    new_com = torch.where(cand != INT32_MAX, cand, com)
    new_com[trash] = trash
    for _ in range(propagate_jumps):  # collapse intra-block adoption chains
        new_com = new_com[new_com.long()]

    if degree_update == "paper":
        new_deg = deg.index_add(0, adoptee, any_adopt.to(torch.int32))
    else:  # original SCoDA: both endpoints bump on every processed edge
        ones = valid.to(torch.int32)
        new_deg = deg.index_add(0, u, ones).index_add_(0, v, ones)
    new_deg[trash] = 0
    return new_com, new_deg


def scoda_init(n_nodes: int, device="cpu"):
    """Fresh SCoDA state: (com, deg), each [n_nodes+1] int32 (last = trash)."""
    com = torch.arange(n_nodes + 1, dtype=torch.int32, device=device)
    deg = torch.zeros(n_nodes + 1, dtype=torch.int32, device=device)
    return com, deg


def scoda_update(state, chunk, threshold: int, cfg: ScodaConfig):
    """One pass of one round over a chunk [C, 2] of the edge stream.

    Padded slots point at the trash node. The chunk is scanned in blocks of
    ``cfg.block_size`` exactly like the one-shot path, so chunked and
    one-shot runs agree bit for bit whenever the chunk size is a multiple
    of the block size.
    """
    trash = state[0].shape[0] - 1
    e = chunk.shape[0]
    bs = min(cfg.block_size, e)
    n_blocks = (e + bs - 1) // bs
    pad = n_blocks * bs - e
    edges = chunk.long()
    if pad:
        fill = torch.full((pad, 2), trash, dtype=torch.long, device=chunk.device)
        edges = torch.cat([edges, fill])
    for k in range(n_blocks):
        state = _block_update(
            state, edges[k * bs:(k + 1) * bs],
            threshold=threshold,
            tie_break=cfg.tie_break,
            degree_update=cfg.degree_update,
            exact_block_degrees=cfg.exact_block_degrees,
            conflict=cfg.conflict,
            propagate_jumps=cfg.propagate_jumps,
        )
    return state


def sharded_scoda_update(state, local, threshold: int, cfg: ScodaConfig, mesh):
    """``scoda_update`` of one chunk whose rows are spread over ``mesh``.

    ``local`` [C/D, 2] holds this rank's slice of every block of the chunk,
    block after block (``block_chunk_spec(mesh, cfg.block_size)``); state
    and threshold are replicated. Each block is gathered whole and run as
    in ``scoda_update``, in the chunk's block order, so the replicated
    result is bitwise the single-rank one. Requires ``cfg.block_size % D ==
    0`` and a chunk of whole blocks (the engine gates on both)."""
    per = cfg.block_size // mesh.size
    for k in range(local.shape[0] // per):
        state = _block_update(
            state, local[k * per:(k + 1) * per],
            threshold=threshold,
            tie_break=cfg.tie_break,
            degree_update=cfg.degree_update,
            exact_block_degrees=cfg.exact_block_degrees,
            conflict=cfg.conflict,
            propagate_jumps=cfg.propagate_jumps,
            mesh=mesh,
        )
    return state


def scoda_finalize(state, n_nodes: int, cfg: ScodaConfig):
    com, deg = state
    if cfg.compress_labels:
        # log2(n) pointer jumps always reach the fixpoint; 32 covers any int32 n.
        for _ in range(32):
            com = com[com.long()]
    return com[:n_nodes], deg[:n_nodes]


def detect_communities(edges, n_nodes: int, cfg: ScodaConfig):
    """Multi-round block-streamed SCoDA over the whole edge list as one chunk.

    edges: [E, 2] int tensor (padded slots = n_nodes).
    Returns (labels [n_nodes] int32 — community = representative node id,
             deg [n_nodes] int32 — SCoDA working degrees).
    """
    state = scoda_init(n_nodes, edges.device)
    for i in range(cfg.rounds):
        state = scoda_update(state, edges, round_threshold(cfg, i), cfg)
    return scoda_finalize(state, n_nodes, cfg)


def dense_labels(labels, n_labels: int):
    """Relabel arbitrary int community ids to dense [0, S).

    Returns (dense [N] int32, n_communities scalar int32 tensor).
    ``n_labels`` is the reference's static capacity (≥ the true community
    count); the port sizes the unique set exactly.
    """
    uniq = torch.unique(labels, sorted=True)[:n_labels]
    dense = torch.searchsorted(uniq, labels).to(torch.int32)
    n_communities = torch.tensor(
        uniq.shape[0], dtype=torch.int32, device=labels.device
    )
    return dense, n_communities
