"""FA2's attraction sum in a fixed order. On the CPU the two-scatter form
keeps its ``index_add_`` and the sorted form sums through the plain
version of K7's fused ``attraction_sum`` (both bitwise the forms before
the sum moved to kernel K7 on the card, kept here as the oracle); the
card's forms — the terms sorted stably by node id, then summed in row
order, or formed in the kernel through the source layout's offsets — are
run here through K7's plain versions and must give the same bits, trash
ids (== n) dropped. The card itself is held run to run by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.kernels.segment.ref import segment_sum_ref  # noqa: E402


def _inputs(n, e, seed):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-e // 8:] = n  # trash-padded slots
    edges[: e // 16, 1] = edges[: e // 16, 0]  # self loops
    w = rng.integers(1, 6, e).astype(np.float32)
    pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    return torch.as_tensor(edges), torch.as_tensor(w), torch.as_tensor(pos)


def _old_two_scatter(pos, edges, weights, n):
    e = edges.long().clamp(0, n)
    u, v = e[:, 0], e[:, 1]
    pos_ext = torch.cat([pos, torch.zeros((1, 2), dtype=pos.dtype)])
    f = weights[:, None] * (pos_ext[v] - pos_ext[u])
    force = torch.zeros((n + 1, 2), dtype=pos.dtype)
    force.index_add_(0, u, f)
    force.index_add_(0, v, -f)
    return force[:n], torch.cat([f, -f]), torch.cat([u, v])


def _old_sorted(pos, edges, weights, n):
    u, v = edges[:, 0].long(), edges[:, 1].long()
    order = torch.argsort(torch.cat([u, v]), stable=True)
    src, dst = torch.cat([u, v])[order], torch.cat([v, u])[order]
    w = torch.cat([weights, weights])[order]
    pos_ext = torch.cat([pos, torch.zeros((1, 2), dtype=pos.dtype)])
    s, d = src.clamp(0, n), dst.clamp(0, n)
    f = w[:, None] * (pos_ext[d] - pos_ext[s])
    out = torch.zeros((n + 1, 2), dtype=pos.dtype)
    out.index_add_(0, s, f)
    return out[:n], f, s


def _card_order(terms, ids, n):
    """K7's order: a stable sort by id, each segment summed in row order."""
    order = torch.argsort(ids, stable=True)
    return segment_sum_ref(terms[order], ids[order].to(torch.int32), n)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n,e,seed", [(50, 400, 0), (700, 9000, 1), (1, 16, 2)])
def test_attraction_forms_keep_their_bits(n, e, seed):
    edges, w, pos = _inputs(n, e, seed)
    want2, terms2, ids2 = _old_two_scatter(pos, edges, w, n)
    got2 = fa2._attraction(pos, edges, w, n)
    assert torch.equal(_bits(got2), _bits(want2))
    assert torch.equal(_bits(_card_order(terms2, ids2, n)), _bits(want2))

    wants, terms, ids = _old_sorted(pos, edges, w, n)
    dst, w2, lay = fa2._attraction_edge_layout(edges, w, n)
    assert dst.dtype == torch.int32 and lay.offsets.dtype == torch.int32 and lay.perm is None
    # the offsets are the segment starts of the sorted (clamped) sources
    want_off = np.searchsorted(ids.numpy(), np.arange(n + 1))
    assert np.array_equal(lay.offsets.numpy(), want_off)
    gots = fa2._attraction_sorted(pos, dst, w2, lay)
    assert torch.equal(_bits(gots), _bits(wants))
    assert torch.equal(_bits(_card_order(terms, ids, n)), _bits(wants))
    # the sorted form is K7's input as it stands: ids already ascending
    assert torch.equal(_bits(segment_sum_ref(terms, ids.to(torch.int32), n)), _bits(wants))
