"""Supergraph construction (paper §4.1): communities → weighted supernodes,
inter-community edges → weighted superedges.

Static-capacity form: superedges are deduplicated into a fixed
``max_super_edges`` capacity, kept sorted by canonicalized (min, max)
community pair. Two aggregation backends share the contract
(``agg_backend``): the ``"lexsort"`` full re-sort, and the default
``"merge"`` two-level scheme built on ``kernels/merge`` (kernel K1).

Chunk-incremental aggregation (core/stream.py engine): the state is the
partially aggregated superedge set — three [cap] tensors (a, b, w) sorted by
(a, b) with padded slots at (s_cap, s_cap, 0), plus the live count. Each
update maps a chunk of node edges through the community labels and combines
it into the state:

  * "merge" (default) — the chunk is deduped locally (one sort of only its
    C entries), then merges into the sorted state through merge-path ranks
    and one scatter — O(C log C + cap + C) per chunk.
  * "lexsort" — concatenate state + chunk, one full sort, segment-sum back
    into capacity — O((cap + C)·log(cap + C)) per chunk. It is the
    bit-identity oracle of the merge path.

Both are bit-for-bit identical below capacity (weights are edge counts,
exactly representable), and both skip all-invalid chunks. After the final
chunk the state IS the deduplicated superedge list, identical to a one-shot
aggregation of the full edge list.

Capacity overflow (> max_super_edges unique pairs) truncates the sorted
tail in both backends — every update keeps the lexicographically smallest
``cap`` pairs and drops the weight of the rest, while ``n_superedges``
still counts every unique pair of the latest update's union. The
truncation point then depends on chunk order, so chunked == one-shot holds
only below capacity.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import cms as cms_lib
from repro_torch.core.scoda import dense_labels
from repro_torch.kernels.merge import ops as merge_ops
from repro_torch.kernels.merge.ref import SENTINEL, pack_keys, unpack_keys


@dataclass
class Supergraph:
    """Padded supergraph. Padded superedge slots point at ``s_cap`` (trash)."""

    edges: torch.Tensor  # [max_super_edges, 2] int32, dense community ids
    weights: torch.Tensor  # [max_super_edges] float32 (edge multiplicity)
    sizes: torch.Tensor  # [s_cap] float32 supernode weights (CMS estimate)
    n_supernodes: torch.Tensor  # scalar int32
    n_superedges: torch.Tensor  # scalar int32
    labels: torch.Tensor  # [n_nodes] int32 node → dense community id


def agg_init(s_cap: int, max_super_edges: int, device="cpu"):
    """Empty aggregation state: (a [cap], b [cap], w [cap], n_superedges)."""
    return (
        torch.full((max_super_edges,), s_cap, dtype=torch.int32, device=device),
        torch.full((max_super_edges,), s_cap, dtype=torch.int32, device=device),
        torch.zeros(max_super_edges, dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def _chunk_pairs(chunk, labels_ext, s_cap: int):
    """Map node edges → canonical community pairs; invalid → (s_cap, s_cap, 0).

    ``chunk`` [C,2] node edges (padded slots point at the trash node);
    ``labels_ext`` [n_nodes+1] dense community per node with the trash slot
    mapped to ``s_cap``.
    """
    trash = labels_ext.shape[0] - 1
    cu = labels_ext[chunk[:, 0].long().clamp(0, trash)]
    cv = labels_ext[chunk[:, 1].long().clamp(0, trash)]
    a = torch.minimum(cu, cv)
    b = torch.maximum(cu, cv)
    valid = (a != b) & (a < s_cap) & (b < s_cap)
    a = torch.where(valid, a, s_cap).to(torch.int32)
    b = torch.where(valid, b, s_cap).to(torch.int32)
    w = valid.to(torch.float32)
    return a, b, w


def _agg_update_lexsort(state, a, b, w, s_cap: int, max_super_edges: int):
    """Baseline: one full sort of state + chunk, segment-sum re-dedupe."""
    pa, pb, pw, _ = state
    ca = torch.cat([pa, a])
    cb = torch.cat([pb, b])
    cw = torch.cat([pw, w])
    # Sort by (a, b); invalid slots (s_cap, s_cap) sort last.
    order = torch.argsort(ca.long() * (s_cap + 1) + cb.long(), stable=True)
    a_s, b_s, w_s = ca[order], cb[order], cw[order]
    new_pair = torch.ones_like(a_s, dtype=torch.bool)
    new_pair[1:] = (a_s[1:] != a_s[:-1]) | (b_s[1:] != b_s[:-1])
    new_pair = new_pair & (a_s != s_cap)
    seg = torch.cumsum(new_pair, 0) - 1  # dense superedge id per sorted slot
    # Invalid and overflow slots route to the scratch slot, cut off below.
    seg = torch.where((a_s != s_cap) & (seg < max_super_edges), seg, max_super_edges)
    dev = a.device
    sw = torch.zeros(max_super_edges + 1, dtype=torch.float32, device=dev)
    sw.index_add_(0, seg, w_s)
    sa = torch.full((max_super_edges + 1,), s_cap, dtype=torch.int32, device=dev)
    sb = torch.full((max_super_edges + 1,), s_cap, dtype=torch.int32, device=dev)
    sa[seg] = a_s
    sb[seg] = b_s
    sa[max_super_edges] = s_cap
    sb[max_super_edges] = s_cap
    n_superedges = new_pair.sum().to(torch.int32)
    return sa[:max_super_edges], sb[:max_super_edges], sw[:max_super_edges], n_superedges


def _dedupe_chunk(a, b, w, s_cap: int):
    """Level one of the merge scheme: sort + combine only the C chunk pairs.

    Returns (ca, cb, cw): a sorted run of the chunk's unique valid pairs
    with summed multiplicities, padded with (s_cap, s_cap, 0) slots.
    """
    c = a.shape[0]
    key = pack_keys(a, b, s_cap)
    k_s, order = torch.sort(key)
    w_s = w[order]
    first = torch.ones_like(k_s, dtype=torch.bool)
    first[1:] = k_s[1:] != k_s[:-1]
    first = first & (k_s != SENTINEL)
    seg = torch.cumsum(first, 0) - 1  # dense local id per sorted slot
    seg = torch.where(k_s != SENTINEL, seg, c)
    cw = torch.zeros(c + 1, dtype=torch.float32, device=a.device)
    cw.index_add_(0, seg, w_s)
    ck = torch.full((c + 1,), SENTINEL, dtype=torch.long, device=a.device)
    ck[seg] = k_s  # every row of a segment writes the same key
    ca, cb = unpack_keys(ck[:c], s_cap)
    return ca, cb, cw[:c]


def _agg_update_merge(state, a, b, w, s_cap: int):
    """Two-level scheme: local chunk dedupe, then sorted-merge into state."""
    pa, pb, pw, _ = state
    ca, cb, cw = _dedupe_chunk(a, b, w, s_cap)
    return merge_ops.merge_combine(pa, pb, pw, ca, cb, cw, s_cap)


def agg_update(state, chunk, labels_ext, s_cap: int, max_super_edges: int,
               agg_backend: str = "merge"):
    """Combine one edge chunk into the aggregation state.

    An all-invalid chunk (every edge intra-community or trash-padded) is a
    no-op for either backend and returns ``state`` untouched — this costs
    one device→host read of a flag per chunk.
    """
    if agg_backend not in ("merge", "lexsort"):
        raise ValueError(f"unknown agg_backend {agg_backend!r}")
    a, b, w = _chunk_pairs(chunk, labels_ext, s_cap)
    if not bool((a != s_cap).any()):
        return state
    if agg_backend == "lexsort":
        return _agg_update_lexsort(state, a, b, w, s_cap, max_super_edges)
    return _agg_update_merge(state, a, b, w, s_cap)


def sharded_agg_update(state, local, labels_ext, s_cap: int, max_super_edges: int,
                       agg_backend: str, mesh):
    """``agg_update`` of a chunk whose rows are spread over ``mesh``
    (``local`` is this rank's [C/D, 2] share, ``row_chunk_spec``); state and
    labels replicated, the result too.

    Merge path: each rank maps and dedupes its own rows (the sort, D ways
    parallel), one all-gather concatenates the local runs in rank order and
    a second dedupe restores the single sorted run — the same unique pairs
    with the same integer-valued summed weights as the one-rank dedupe, so
    ``merge_combine`` (kernel K1) gets bitwise the same input, at capacity
    overflow too. Lexsort path: the gathered rows are the chunk verbatim.
    The all-invalid short-circuit reads the gathered (replicated) pairs, so
    every rank takes the same branch."""
    from repro_torch.sharding.collectives import all_gather_rows

    if agg_backend not in ("merge", "lexsort"):
        raise ValueError(f"unknown agg_backend {agg_backend!r}")
    a, b, w = _chunk_pairs(local, labels_ext, s_cap)
    if agg_backend == "merge":
        a, b, w = _dedupe_chunk(a, b, w, s_cap)
    # One gather of the three columns, the weights carried as their bits.
    g = all_gather_rows(torch.stack([a, b, w.view(torch.int32)], dim=1), mesh)
    ga, gb, gw = g[:, 0].contiguous(), g[:, 1].contiguous(), \
        g[:, 2].contiguous().view(torch.float32)
    if not bool((ga != s_cap).any()):
        return state
    if agg_backend == "lexsort":
        return _agg_update_lexsort(state, ga, gb, gw, s_cap, max_super_edges)
    return _agg_update_merge(state, ga, gb, gw, s_cap)


def agg_finalize(state):
    """(sedges [cap,2], sweights [cap], n_superedges) from aggregation state."""
    a, b, w, n = state
    return torch.stack([a, b], dim=1), w, n


def aggregate_edges(edges, labels_dense, s_cap: int, max_super_edges: int,
                    agg_backend: str = "merge"):
    """Map node edges through community labels, drop intra edges, dedupe
    (one-shot: the whole edge list as a single chunk).

    Returns (sedges [cap,2], sweights [cap], n_superedges).
    """
    dev = labels_dense.device
    labels_ext = torch.cat(
        [labels_dense, torch.full((1,), s_cap, dtype=torch.int32, device=dev)]
    )
    state = agg_init(s_cap, max_super_edges, dev)
    state = agg_update(state, edges, labels_ext, s_cap, max_super_edges, agg_backend)
    return agg_finalize(state)


def community_sizes(labels_dense, node_deg, n_supernodes, s_cap: int,
                    cms_cfg: cms_lib.CMSConfig, mesh=None):
    """CMS-estimated community sizes (paper §4.1): one sketch update per node,
    weight = its true graph degree; queries beyond the live count are masked.

    With a ``mesh`` of more than one rank the node keys are spread over the
    ranks and the sketches summed (``cms.sharded_update``): exact, since
    degrees are integer-valued.
    """
    dev = labels_dense.device
    sketch = cms_lib.init(cms_cfg, device=dev)
    weights = node_deg.to(torch.float32)
    if mesh is not None and mesh.size > 1:
        sketch = cms_lib.sharded_update(sketch, labels_dense, weights, cms_cfg, mesh)
    else:
        sketch = cms_lib.update(sketch, labels_dense, weights, cms_cfg)
    keys = torch.arange(s_cap, dtype=torch.int32, device=dev)
    sizes = cms_lib.query(cms_lib.finalize(sketch), keys, cms_cfg)
    return torch.where(keys < n_supernodes, sizes, 0.0)


def build_supergraph(edges, labels, node_deg, n_nodes: int, s_cap: int,
                     max_super_edges: int, cms_cfg: cms_lib.CMSConfig,
                     agg_backend: str = "merge") -> Supergraph:
    """Full paper path: dense-relabel communities, CMS-size them, dedupe edges.

    Community size (paper §4.1): sum of *graph* degrees of member nodes,
    accumulated through the count–min sketch keyed by community id.
    """
    labels_dense, n_supernodes = dense_labels(labels, n_nodes)
    sizes = community_sizes(labels_dense, node_deg, n_supernodes, s_cap, cms_cfg)
    sedges, sweights, n_superedges = aggregate_edges(
        edges, labels_dense, s_cap, max_super_edges, agg_backend
    )
    return Supergraph(
        edges=sedges,
        weights=sweights,
        sizes=sizes,
        n_supernodes=n_supernodes,
        n_superedges=n_superedges,
        labels=labels_dense,
    )
