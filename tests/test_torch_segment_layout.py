"""K7's segment layout and the sums through it, on the CPU (the plain
versions the card's kernels are held against by ``chip_smoke.py``).

* ``segment_layout`` against numpy's stable argsort and ``searchsorted``:
  negative and trash ids (≥ N), empty segments, N = 1, no rows.
* The per-edge sum through a layout (both the sort-order ``perm`` and a
  layout of sorted ids) bitwise ``segment_sum_ref`` on the same ids.
* The fused attraction's plain version bitwise the sorted attraction's
  CPU form before it (gathers of ``pos_ext``, the terms, one
  ``index_add_``), which the attraction and FA2 tests hold against the
  reference.
* The GNNs (GIN, GAT, MPNN): the forward pass and ``torch.autograd.grad``
  with the layouts built once a call bitwise those with a layout built in
  every sum and gather backward, and within ``GRAD_TOL`` of the
  reference's ``jax.grad``; a GIN forward and backward build exactly 2
  layouts, remat included.

Tolerance: the port's and the reference's forward passes and gradients
sum the same terms in different orders (float32): measured within 3.6e-7
of max|out| and 1.9e-6 of each gradient leaf's max|g| (GAT's; the others
within 6.8e-7) on these inputs. ``GRAD_TOL`` leaves a margin of 5 over
that, and stays inside ``tests/test_torch_models.py``'s 2e-4 for the GNN
forward pass.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.gnn_archs import smoke_gnn as jsmoke_gnn  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models.param import init_params as jinit_params  # noqa: E402

from repro_torch.configs.gnn_archs import smoke_gnn  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.kernels.segment import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment.ref import (  # noqa: E402
    attraction_sum_ref,
    segment_layout_ref,
    segment_sum_ref,
)
from repro_torch.models import gnn as gnn_lib  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402

GRAD_TOL = 1e-5
CASES = ("mixed", "empty_segments", "one_segment", "all_dropped", "no_rows", "long_segment")


def _ids(case, seed=0):
    """(ids int32, N) for one case."""
    rng = np.random.default_rng(seed)
    if case == "mixed":  # negatives, trash (== N and above), every segment
        n = 40
        ids = rng.integers(-5, n + 5, 600)
        ids[::9] = n
    elif case == "empty_segments":  # empty at both ends and between
        n = 200
        ids = rng.choice(np.arange(10, n - 10, 7), 300)
    elif case == "one_segment":  # N = 1, with dropped rows on both sides
        n = 1
        ids = rng.integers(-1, 3, 50)
    elif case == "all_dropped":
        n = 8
        ids = np.where(rng.random(30) < 0.5, -3, n + 1)
    elif case == "no_rows":
        n = 5
        ids = np.zeros(0, np.int64)
    else:  # one segment holds most rows
        n = 12
        ids = rng.integers(0, n, 900)
        ids[rng.random(900) < 0.8] = 4
    return ids.astype(np.int32), n


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("case", CASES)
def test_layout_matches_numpy(case):
    ids, n = _ids(case)
    order = np.argsort(ids, kind="stable")
    want_off = np.searchsorted(ids[order], np.arange(n + 1), side="left")
    lay = seg_ops.segment_layout(torch.as_tensor(ids), n)
    assert lay.perm.dtype == torch.int32 and lay.offsets.dtype == torch.int32
    assert np.array_equal(lay.perm.numpy(), order)
    assert np.array_equal(lay.offsets.numpy(), want_off)
    assert lay.n_segments == n and torch.equal(lay.ids, torch.as_tensor(ids))
    # The rows of segment s are the rows with id s, in their order.
    for s in range(n):
        rows = lay.perm[lay.offsets[s]:lay.offsets[s + 1]].numpy()
        assert np.array_equal(rows, np.flatnonzero(ids == s))
    # Sorted ids: no perm, the same offsets.
    srt = seg_ops.segment_layout(torch.as_tensor(ids[order]), n, sorted=True)
    assert srt.perm is None and np.array_equal(srt.offsets.numpy(), want_off)
    # int64 ids give the int32 layout.
    perm64, off64 = segment_layout_ref(torch.as_tensor(ids.astype(np.int64)), n)
    assert torch.equal(perm64, lay.perm) and torch.equal(off64, lay.offsets)
    _check_groups(lay.groups.numpy(), want_off, ids.shape[0])


def _check_groups(groups, offsets, rows):
    """The narrow kernels' warps: groups cover [0, N) in order, never cross
    a block of 32 segments, a block of at most SPLIT_ROWS rows is one
    group, and a heavier block starts a group wherever a segment's first
    row enters a new GROUP_ROWS window."""
    n = offsets.shape[0] - 1
    assert groups.dtype == np.int32
    assert groups.shape[0] == n // 32 + 2 + rows // seg_ops.GROUP_ROWS
    assert groups[0] == (0 if n else n) and groups[-1] == n
    assert (np.diff(groups) >= 0).all()

    def heavy(s):
        b = s // 32 * 32
        return offsets[min(b + 32, n)] - offsets[b] > seg_ops.SPLIT_ROWS

    win = offsets // seg_ops.GROUP_ROWS
    want = [s for s in range(n) if s % 32 == 0 or (heavy(s) and win[s] != win[s - 1])]
    assert groups[groups < n].tolist() == want


@pytest.mark.parametrize("seed", range(3))
def test_groups_bound_many_long_segments(seed):
    """A run of long segments (a supergraph's large communities) splits
    into one group each; short ones stay 32 to a group."""
    rng = np.random.default_rng(seed)
    g = seg_ops.GROUP_ROWS  # a segment this long starts a window of its own
    lengths = np.concatenate([rng.integers(g, 4 * g, 40), rng.integers(0, 20, 504),
                              rng.integers(100, 400, 60)])
    ids = np.repeat(np.arange(lengths.shape[0]), lengths).astype(np.int32)
    lay = seg_ops.segment_layout(torch.as_tensor(ids), lengths.shape[0], sorted=True)
    offsets = lay.offsets.numpy()
    _check_groups(lay.groups.numpy(), offsets, ids.shape[0])
    groups = lay.groups.numpy()
    assert all(groups[k + 1] - groups[k] == 1 for k in range(40))  # one long segment each
    light = groups[(groups >= 64) & (groups < 544)]  # the short segments' blocks
    assert light.tolist() == list(range(64, 544, 32))


# ------------------------------------------------- sums through a layout
@pytest.mark.parametrize("d", [0, 1, 2, 3, 8, 64])
@pytest.mark.parametrize("case", CASES)
def test_sum_through_layout_is_bitwise(case, d):
    """d = 0: 1-D data."""
    ids, n = _ids(case, seed=d)
    rng = np.random.default_rng(100 + d)
    shape = (ids.shape[0],) if d == 0 else (ids.shape[0], d)
    data = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 1e3)
    ids_t = torch.as_tensor(ids)
    want = segment_sum_ref(data, ids_t, n)
    lay = seg_ops.segment_layout(ids_t, n)
    for got in (seg_ops.segment_sum_edges(data, lay, n),
                seg_ops.segment_sum_edges(data, ids_t, n)):  # a layout for the call
        assert got.shape == want.shape and torch.equal(_bits(got), _bits(want))
    # A layout of the sorted ids reads the rows where they lie.
    order = torch.as_tensor(np.argsort(ids, kind="stable"))
    srt = seg_ops.segment_layout(ids_t[order], n, sorted=True)
    assert torch.equal(_bits(seg_ops.segment_sum_edges(data[order], srt, n)), _bits(want))


def test_layout_must_fit_its_data():
    ids = torch.as_tensor(np.arange(10, dtype=np.int32) % 4)
    lay = seg_ops.segment_layout(ids, 4)
    with pytest.raises(ValueError, match="segments"):
        seg_ops.segment_sum_edges(torch.zeros(10, 2), lay, 5)
    with pytest.raises(ValueError, match="rows"):
        seg_ops.segment_sum_edges(torch.zeros(9, 2), lay, 4)
    with pytest.raises(ValueError, match="segments"):
        seg_ops.gather_rows(torch.zeros(5, 2), ids, lay)


# ---------------------------------------------------- the fused attraction
def _cpu_form(pos, src, dst, w, n):
    """The sorted attraction's CPU form before the fused entry: gathers of
    ``pos_ext``, the [E, 2] terms, one ``index_add_`` by the clamped
    sources."""
    pos_ext = torch.cat([pos, torch.zeros((1, 2), dtype=pos.dtype)])
    s, d = src.long().clamp(0, n), dst.long().clamp(0, n)
    f = w[:, None] * (pos_ext[d] - pos_ext[s])
    out = torch.zeros((n + 1, 2), dtype=pos.dtype)
    out.index_add_(0, s, f)
    return out[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,e,seed", [(60, 700, 0), (1, 20, 1), (500, 6000, 2)])
def test_fused_attraction_plain_matches_cpu_form(n, e, seed, dtype):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-e // 8:] = n  # trash-padded slots
    edges[: e // 16, 1] = edges[: e // 16, 0]  # self loops
    edges[5, 1] = n + 3  # a destination past the zero row reads it
    edges[6, 0] = -1  # a negative source joins node 0, clamped
    edges[7, 1] = -2  # a negative destination reads row 0
    pos = torch.as_tensor(rng.uniform(-1000, 1000, (n, 2))).to(dtype)
    w = torch.as_tensor(rng.integers(1, 6, e)).to(dtype)
    edges_t = torch.as_tensor(edges)
    u, v = edges_t[:, 0], edges_t[:, 1]
    order = torch.argsort(torch.cat([u, v]), stable=True)
    src, dst = torch.cat([u, v])[order], torch.cat([v, u])[order]
    w2 = torch.cat([w, w])[order]
    want = _cpu_form(pos, src, dst, w2, n)
    lay = seg_ops.segment_layout(src.clamp(0, n), n, sorted=True)
    for got in (attraction_sum_ref(pos, dst, w2, lay.offsets),
                seg_ops.attraction_sum(pos, dst, w2, lay),
                fa2._attraction_sorted(pos, *fa2._attraction_edge_layout(edges_t, w, n))):
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))


# -------------------------------------------------------------- the GNNs
def _gnn(arch, task="node_class", seed=0, n=48, e=120):
    jcfg = jsmoke_gnn(arch)
    cfg = smoke_gnn(arch)
    if task != "node_class":
        import dataclasses

        n_out = 3 if task == "node_reg" else 2
        jcfg = dataclasses.replace(jcfg, task=task, n_out=n_out)
        cfg = dataclasses.replace(cfg, task=task, n_out=n_out)
    jp = jinit_params(jax.random.PRNGKey(seed), jgnn.param_specs(jcfg))
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-7:] = n  # trash padding
    batch = {"feats": rng.standard_normal((n, cfg.d_feat)).astype(np.float32), "edges": edges,
             "mask": (rng.random(n) < 0.7).astype(np.float32)}
    if task == "node_reg":
        batch["labels"] = rng.standard_normal((n, cfg.n_out)).astype(np.float32)
    elif task == "graph_class":
        batch["graph_ids"] = np.repeat(np.arange(4), n // 4).astype(np.int32)
        batch["labels"] = rng.integers(0, cfg.n_out, 4).astype(np.int32)
        batch["mask"] = np.ones(4, np.float32)
    else:
        batch["labels"] = rng.integers(0, cfg.n_out, n).astype(np.int32)
    params = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, cfg, jp, params, batch


def _grads(cfg, params, batch):
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    out = gnn_lib.forward(cfg, params, batch)
    grads = torch.autograd.grad(gnn_lib.gnn_loss(cfg, params, batch), leaves)
    for p in leaves:
        p.requires_grad_(False)
    return out.detach(), grads


def _bare_ids(monkeypatch):
    """Every sum and gather backward given bare ids: a layout each call."""
    monkeypatch.setattr(gnn_lib, "_gather", lambda x, lay: seg_ops.gather_rows(x, lay.ids))
    monkeypatch.setattr(gnn_lib, "_segsum",
                        lambda d, lay, n: seg_ops.segment_sum_edges(d, lay.ids, n))


@pytest.mark.parametrize("arch,task", [("gin", "node_class"), ("gat", "node_class"),
                                       ("meshgraphnet", "node_reg"), ("gin", "graph_class")])
def test_gnn_layouts_bitwise_and_against_jax(arch, task, monkeypatch):
    import dataclasses

    jcfg, cfg, jp, params, batch = _gnn(arch, task)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out, grads = _grads(cfg, params, tb)
    out_r, grads_r = _grads(dataclasses.replace(cfg, remat=True), params, tb)
    with monkeypatch.context() as mp:
        _bare_ids(mp)
        out_b, grads_b = _grads(cfg, params, tb)
    for a, b in zip((out, *grads), (out_b, *grads_b)):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip((out, *grads), (out_r, *grads_r)):
        assert torch.equal(_bits(a), _bits(b))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.grad(functools.partial(jgnn.gnn_loss, jcfg))(jp, jb)
    jout = np.asarray(jgnn.forward(jcfg, jp, jb))
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=GRAD_TOL * np.abs(jout).max())
    jl = jax.tree_util.tree_leaves(jgrads)
    assert len(jl) == len(grads)
    for g, w in zip(grads, jl):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("arch,want", [("gin", 2), ("gat", 2), ("meshgraphnet", 4)])
def test_gnn_builds_its_layouts_once(arch, want, monkeypatch):
    """A gin-tu-shaped step (node classification, remat on): the forward
    builds one layout for src and one for dst, and the backward (the
    recomputed layers included) builds none."""
    import dataclasses

    task = "node_reg" if arch == "meshgraphnet" else "node_class"
    _, cfg, _, params, batch = _gnn(arch, task, seed=3)
    cfg = dataclasses.replace(cfg, remat=True)
    built = []
    real = seg_ops.segment_layout

    def counting(*args, **kw):
        built.append(args[1])
        return real(*args, **kw)

    monkeypatch.setattr(seg_ops, "segment_layout", counting)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = gnn_lib.gnn_loss(cfg, params, tb)
    assert len(built) == want
    torch.autograd.grad(loss, leaves)
    assert len(built) == want
    n = batch["feats"].shape[0]
    assert sorted(built) == ([n] * 2 + [n + 1] * 2 if want == 4 else [n] * 2)
