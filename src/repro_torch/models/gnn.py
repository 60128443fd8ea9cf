"""GNN family: GIN, GAT, MeshGraphNet, GraphCast (encode-process-decode).

All four share one substrate: message passing = gather(src) → edge
compute → segment sum scatter(dst). Edges are padded with the trash id
(= n_nodes): a gather clamps it to the last row, as the reference's does,
and the segment sum drops it.

The segment sums go through ``kernels/segment``'s per-edge entry: kernel
K7 on the card, so every sum is added in row order and the card's forward
pass is the same bits from run to run (an ``index_add_`` there would add
on float atomics); its plain version on the CPU. The row gathers go
through ``kernels/segment.gather_rows``, whose backward sums the edge
gradients into their rows through K7 as well, so a training step on the
card is the same bits from run to run too. That is a choice of this port,
not a kernel of the reference (whose sums are its compiler's).

``forward`` builds one segment layout (``segment_ops.segment_layout``: a
stable sort by id and the segment offsets) for each distinct (id array,
row count) before the layer loop, and every sum and gather backward of
the call, remat's recomputed layers included, reads its rows through
those: a GIN or GAT forward builds 2, an MPNN's 4 (src and dst over the n
nodes, and over ``h_ext``'s n + 1 rows), and no launch sorts or copies
its data. A graph-level pool sums through a layout of its own.

On a ``ModelMesh`` (``forward``/``gnn_loss`` with a ``Placement``, profile
"gnn") the parameters are replicated, the edges split contiguously over
every axis, and the node state split over every axis too, as the
reference's ``build_gnn_step`` constrains ``h`` (``NodeSplit``): rank j
holds node rows ``[j·c, (j+1)·c)``, c = ceil(N / D), after the input MLP
and after every layer (the last blocks may be short or empty). Node
inputs arrive as those blocks where the step's specs split them, else
whole and cut here. A layer all-gathers the node tensors its edges read
(``h``; GAT's ``q``, ``es`` and ``ed``, computed on the rank's rows first)
through ``gather_blocks``, whose backward sums the ranks' gradients and
keeps the block; each rank sums its edges' messages through its K7
layouts into full-size [N, ·] partials, and ``reduce_blocks`` adds them
and keeps the rank's rows; the node MLPs run on those rows only. Every
parameter enters through ``copy_to`` (its gradient summed over the
ranks), but a graph-level readout's, which runs whole on every rank.
GAT's per-node max is an all-reduce max, its softmax denominators a sum
over the ranks (``sum_shards``) read on the rank's edges. ``forward``
returns the rank's block of rows (the pooled graphs whole, for
``graph_class``); ``gnn_loss`` adds the masked terms and the mask count
over the ranks, so every rank returns the same global loss. The result is
within rounding of the one-rank forward (each node's message sum is one
chain a rank plus their sum), not its bits.

``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), as the reference's
``checkpoint(..., nothing_saveable)`` does: at ogbn-products' 61.9 M
edges one gathered [E, 64] tensor is 15.8 GB.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.segment import ops as segment_ops
from repro_torch.models.param import ParamSpec


@dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str  # gin | gat | meshgraphnet | graphcast
    n_layers: int
    d_hidden: int
    d_feat: int
    n_out: int
    n_heads: int = 1  # gat
    task: str = "node_class"  # node_class | graph_class | node_reg
    act_dtype: Any = torch.float32
    remat: bool = False


def param_specs(cfg: GNNConfig) -> dict:
    nl, d = cfg.n_layers, cfg.d_hidden
    dt = torch.float32
    specs = {
        "in_w": ParamSpec((cfg.d_feat, d), ("gnn_feat", "gnn_hidden"), "scaled", dt),
        "in_b": ParamSpec((d,), ("gnn_hidden",), "zeros", dt),
        "out_w": ParamSpec((d, cfg.n_out), ("gnn_hidden", "gnn_out"), "scaled", dt),
        "out_b": ParamSpec((cfg.n_out,), ("gnn_out",), "zeros", dt),
    }
    if cfg.arch == "gin":
        specs["layers"] = {
            "eps": ParamSpec((nl,), ("layer",), "zeros", dt),
            "w1": ParamSpec((nl, d, d), ("layer", "gnn_hidden", "gnn_mlp"), "scaled", dt),
            "b1": ParamSpec((nl, d), ("layer", "gnn_mlp"), "zeros", dt),
            "w2": ParamSpec((nl, d, d), ("layer", "gnn_mlp", "gnn_hidden"), "scaled", dt),
            "b2": ParamSpec((nl, d), ("layer", "gnn_hidden"), "zeros", dt),
        }
    elif cfg.arch == "gat":
        h = cfg.n_heads
        dh = d // h
        specs["layers"] = {
            "w": ParamSpec((nl, d, h, dh), ("layer", "gnn_hidden", "heads", "gnn_mlp"), "scaled", dt),
            "a_src": ParamSpec((nl, h, dh), ("layer", "heads", "gnn_mlp"), "scaled", dt),
            "a_dst": ParamSpec((nl, h, dh), ("layer", "heads", "gnn_mlp"), "scaled", dt),
        }
    else:  # meshgraphnet / graphcast: MPNN with edge + node MLPs
        specs["edge_in_w"] = ParamSpec((2 * d, d), ("gnn_concat", "gnn_hidden"), "scaled", dt)
        specs["edge_in_b"] = ParamSpec((d,), ("gnn_hidden",), "zeros", dt)
        specs["layers"] = {
            "we1": ParamSpec((nl, 3 * d, d), ("layer", "gnn_concat", "gnn_mlp"), "scaled", dt),
            "be1": ParamSpec((nl, d), ("layer", "gnn_mlp"), "zeros", dt),
            "we2": ParamSpec((nl, d, d), ("layer", "gnn_mlp", "gnn_hidden"), "scaled", dt),
            "be2": ParamSpec((nl, d), ("layer", "gnn_hidden"), "zeros", dt),
            "wv1": ParamSpec((nl, 2 * d, d), ("layer", "gnn_concat", "gnn_mlp"), "scaled", dt),
            "bv1": ParamSpec((nl, d), ("layer", "gnn_mlp"), "zeros", dt),
            "wv2": ParamSpec((nl, d, d), ("layer", "gnn_mlp", "gnn_hidden"), "scaled", dt),
            "bv2": ParamSpec((nl, d), ("layer", "gnn_hidden"), "zeros", dt),
        }
    return specs


def _gather(x, lay):
    """``x[ids]`` of a layout's ids, out-of-range ids clamped to the last
    row; its backward sums through ``lay``."""
    return segment_ops.gather_rows(x, lay.ids, lay)


def _segsum(data, lay, n: int):
    return segment_ops.segment_sum_edges(data, lay, n)


@dataclass(frozen=True)
class NodeSplit:
    """A rank's share of the node rows: its block of ``n`` rows split over
    ``axes`` (every live axis of ``mesh``) by ``collectives.block_range``."""

    mesh: Any
    axes: tuple
    n: int


def _whole(x, split):
    """The whole [n, ...] node tensor from every rank's block."""
    if split is None:
        return x
    from repro_torch.sharding.collectives import gather_blocks

    return gather_blocks(x, split.mesh, split.axes, split.n)


def _own(x, split):
    """Full-size [n, ...] partials summed over the ranks, this rank's block kept."""
    if split is None:
        return x
    from repro_torch.sharding.collectives import reduce_blocks

    return reduce_blocks(x, split.mesh, split.axes)


def _gin_layer(h, lp, src, dst, n, split=None):
    hw = _whole(h, split)
    agg = _own(_segsum(_gather(hw, src), dst, n) + _segsum(_gather(hw, dst), src, n),
               split)  # symmetrized
    z = (1.0 + lp["eps"]) * h + agg
    z = F.relu(z @ lp["w1"] + lp["b1"])
    return z @ lp["w2"] + lp["b2"]


def _gat_layer(h, lp, s2, d2, n, split=None):
    """``s2``/``d2``: the layouts of both directions of every undirected
    edge (sources, destinations)."""
    d = h.shape[-1]
    nh, dh = lp["a_src"].shape
    q = (h @ lp["w"].reshape(d, nh * dh)).reshape(-1, nh, dh)
    es = torch.einsum("nhd,hd->nh", q, lp["a_src"])
    ed = torch.einsum("nhd,hd->nh", q, lp["a_dst"])
    if split is not None:  # one gather of the three node tensors the edges read
        q, es, ed = _whole(torch.cat([q.reshape(-1, nh * dh), es, ed], dim=1), split).split(
            [nh * dh, nh, nh], dim=1)
        q = q.reshape(n, nh, dh)
    logit = F.leaky_relu(_gather(es, s2) + _gather(ed, d2), 0.2)  # [2E, H]
    # Numerically stable edge softmax over incoming edges per dst; the max
    # is order-free, and ids ≥ n land in a dropped row. The softmax does not
    # depend on the shift, so its gradient through the max is 0: the max is
    # taken on detached logits, and no backward of "amax" runs.
    ids = d2.ids
    keep = (ids >= 0) & (ids < n)
    mx = torch.full((n + 1, nh), -1e30, dtype=logit.dtype, device=logit.device)
    mx.scatter_reduce_(0, torch.where(keep, ids, n).long()[:, None].expand(-1, nh),
                       logit.detach(), "amax", include_self=True)
    mx = mx[:n]
    if split is not None:  # the max over every rank's incoming edges
        from repro_torch.sharding.collectives import all_reduce_axes, sum_shards

        mx = all_reduce_axes(mx.contiguous(), split.mesh, split.axes, "max")
    ex = torch.exp(logit - _gather(mx, d2))
    denom = _segsum(ex, d2, n)
    if split is not None:  # whole on every rank, read on the rank's edges
        denom = sum_shards(denom, split.mesh, split.axes)
    denom = denom + 1e-9
    alpha = ex / _gather(denom, d2)
    msg = alpha[:, :, None] * _gather(q, s2)
    out = _own(_segsum(msg.reshape(-1, nh * dh), d2, n), split)
    return F.elu(out)


def _mpnn_layer(h, e_feat, lp, src, dst, n, split=None):
    hw = _whole(h, split)
    z = torch.cat([e_feat, _gather(hw, src), _gather(hw, dst)], dim=-1)
    e_new = F.relu(z @ lp["we1"] + lp["be1"]) @ lp["we2"] + lp["be2"]
    e_feat = e_feat + e_new
    agg = _own(_segsum(e_feat, dst, n) + _segsum(e_feat, src, n), split)
    z = torch.cat([h, agg], dim=-1)
    h_new = F.relu(z @ lp["wv1"] + lp["bv1"]) @ lp["wv2"] + lp["bv2"]
    return h + h_new, e_feat


def local_edges(edges, spec, mesh):
    """This rank's edges: its block where the edges are split over every
    axis, else its contiguous share of the whole list."""
    from repro_torch.sharding.rules import spec_axes

    if set(spec_axes(spec or ())) >= set(mesh.live_axes(mesh.axis_names)):
        return edges
    return edges.tensor_split(mesh.size)[mesh.rank]


def node_blocks(cfg: GNNConfig, batch: dict, place):
    """``(batch, split)``: the rank's inputs on ``place``'s mesh and its
    ``NodeSplit`` (``(batch, None)`` on one rank). Node inputs split over
    every axis (the step's specs, where N divides) are the rank's block
    already; the others are gathered whole and cut to the block. The
    graph-level labels and mask of ``graph_class`` stay whole, and the
    edges are the rank's (``local_edges``)."""
    if place is None or place.mesh.size == 1:
        return batch, None
    from repro_torch.sharding.collectives import block_range
    from repro_torch.sharding.params import gather_tree
    from repro_torch.sharding.rules import entry_axes

    mesh, specs = place.mesh, place.batch_specs
    axes = mesh.live_axes(mesh.axis_names)
    graph_level = ("labels", "mask") if cfg.task == "graph_class" else ()

    def is_block(k):
        spec = specs.get(k) or ()
        return k not in graph_level and len(spec) > 0 and \
            tuple(a for a in entry_axes(spec[0]) if mesh.extent(a) > 1) == axes

    out, whole = {}, {}
    for k, v in batch.items():
        if k == "edges":
            out[k] = local_edges(v, specs.get(k), mesh)
        elif is_block(k):
            out[k] = v
        else:
            whole[k] = gather_tree(v, specs.get(k) or (), mesh)
    n = out["feats"].shape[0] * mesh.extent(axes) if is_block("feats") else \
        whole["feats"].shape[0]
    lo, hi = block_range(n, mesh.extent(axes), mesh.index(axes))
    for k, v in whole.items():
        out[k] = v if k in graph_level else v[lo:hi]
    return out, NodeSplit(mesh, axes, n)


def _replicated(cfg: GNNConfig, params: dict, mesh) -> dict:
    """Every parameter through ``copy_to`` (used on the rank's rows or
    edges: its gradient summed over the ranks), but a graph-level readout's,
    which every rank runs whole."""
    from repro_torch.sharding.collectives import copy_to

    whole = ("out_w", "out_b") if cfg.task == "graph_class" else ()

    def one(k, v):
        if isinstance(v, dict):
            return {kk: one(kk, vv) for kk, vv in v.items()}
        return v if k in whole else copy_to(v, mesh, mesh.axis_names)

    return {k: one(k, v) for k, v in params.items()}


def forward(cfg: GNNConfig, params, batch, place=None):
    """batch: feats [N, d_feat], edges [E, 2] (trash id = N), plus
    graph_ids [N] for graph_class. Returns [N, n_out] (or [B, n_out]).
    With ``place`` the batch is the rank's (the step's specs; the module
    docstring), and the result the rank's block of rows (``NodeSplit``),
    or for ``graph_class`` the pooled graphs whole on every rank."""
    return _forward(cfg, params, *node_blocks(cfg, batch, place))


def _forward(cfg: GNNConfig, params, batch, split):
    feats, edges = batch["feats"], batch["edges"]
    n = feats.shape[0] if split is None else split.n
    if split is not None:
        params = _replicated(cfg, params, split.mesh)
    src, dst = edges[:, 0], edges[:, 1]
    if cfg.arch == "gat":  # both directions of every undirected edge
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    # One layout per (id array, row count), shared by every layer.
    src, dst = (segment_ops.segment_layout(ids, n) for ids in (src, dst))

    h = torch.tanh(feats.to(cfg.act_dtype) @ params["in_w"] + params["in_b"])
    layers = params["layers"]
    n_layers = next(iter(layers.values())).shape[0]

    def layer_step(body, *carry):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, *carry, use_reentrant=False)
        return body(*carry)

    if cfg.arch in ("meshgraphnet", "graphcast"):
        hw = _whole(h, split)
        h_ext = torch.cat([hw, torch.zeros((1, hw.shape[1]), dtype=hw.dtype, device=hw.device)])
        # Ids above n read h_ext's zero row (gather_rows clamps them to it).
        e_feat = torch.cat([_gather(h_ext, segment_ops.segment_layout(lay.ids, n + 1))
                            for lay in (src, dst)], dim=-1)
        e_feat = F.relu(e_feat @ params["edge_in_w"] + params["edge_in_b"])
        for i in range(n_layers):
            lp = {k: v[i] for k, v in layers.items()}
            h, e_feat = layer_step(
                lambda h, e, lp=lp: _mpnn_layer(h, e, lp, src, dst, n, split), h, e_feat)
    else:
        layer = _gin_layer if cfg.arch == "gin" else _gat_layer
        for i in range(n_layers):
            lp = {k: v[i] for k, v in layers.items()}
            h = layer_step(lambda h, lp=lp: h + layer(h, lp, src, dst, n, split), h)

    if cfg.task == "graph_class":
        pooled = segment_ops.segment_sum_edges(h, batch["graph_ids"], batch["labels"].shape[0])
        if split is not None:  # every rank's rows' partial sums added
            from repro_torch.sharding.collectives import reduce_from

            pooled = reduce_from(pooled, split.mesh, split.axes)
        return pooled @ params["out_w"] + params["out_b"]
    return h @ params["out_w"] + params["out_b"]


def gnn_loss(cfg: GNNConfig, params, batch, place=None):
    """Masked cross-entropy (``node_class``, ``graph_class``) or masked
    squared error (``node_reg``). With ``place`` each rank adds the terms
    and the mask of its rows, and both are summed over the ranks: every
    rank returns the global loss (``graph_class``: the pooled graphs are
    whole on every rank, and so is the loss)."""
    batch, split = node_blocks(cfg, batch, place)
    out = _forward(cfg, params, batch, split).to(torch.float32)
    labels, mask = batch["labels"], batch["mask"]
    if cfg.task == "node_reg":
        num = torch.sum(torch.square(out - labels) * mask[:, None])
        den = torch.sum(mask) * cfg.n_out
    else:
        logz = torch.logsumexp(out, dim=-1)
        gold = torch.gather(out, -1, labels.long()[:, None])[:, 0]
        num = torch.sum((logz - gold) * mask)
        den = torch.sum(mask)
    if split is not None and cfg.task != "graph_class":
        from repro_torch.sharding.collectives import all_reduce_axes, reduce_from

        # Every rank's loss is the same scalar, so the gradient of a rank's
        # sum passes through unchanged (Megatron's g); the parameters'
        # copy_to and the blocks' gathers add the ranks' parts.
        num = reduce_from(num, split.mesh, split.axes)
        den = all_reduce_axes(den.detach().clone(), split.mesh, split.axes)
    return num / torch.clamp(den, min=1.0)
