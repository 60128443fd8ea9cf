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
"gnn") the parameters are replicated and the edges split contiguously
over every axis (the reference's ``build_gnn_step`` edge placement):
each rank builds the layouts of its own edges, sums its messages through
K7 into full-size [N, D] partials, and one all-reduce over all ranks adds
them (``reduce_from``); every gather of a node tensor onto its edges
enters through ``copy_to``, and the edge MLPs' parameters (MeshGraphNet,
GraphCast) too, so each rank ends with the whole gradient. The node-level
MLPs, the loss and the pooled readout run on every rank. Node inputs held
as blocks are gathered first. The result is within rounding of the
one-rank forward (the partials add in another order), not its bits.

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


def _gather_m(x, lay, mesh):
    """``_gather`` onto the rank's edges: ``x`` (whole on every rank) enters
    through ``copy_to``, so its gradient is summed over the ranks."""
    if mesh is not None:
        from repro_torch.sharding.collectives import copy_to

        x = copy_to(x, mesh, mesh.axis_names)
    return _gather(x, lay)


def _segsum_m(data, lay, n: int, mesh):
    """``_segsum`` of the rank's edges, the ranks' partials added
    (``reduce_from``)."""
    out = _segsum(data, lay, n)
    if mesh is not None:
        from repro_torch.sharding.collectives import reduce_from

        out = reduce_from(out, mesh, mesh.axis_names)
    return out


def _edge_params(lp: dict, names, mesh) -> dict:
    """Parameters used on the rank's edges: their gradients are summed over
    the ranks."""
    if mesh is None:
        return lp
    from repro_torch.sharding.collectives import copy_to

    return {k: copy_to(v, mesh, mesh.axis_names) if k in names else v for k, v in lp.items()}


def _gin_layer(h, lp, src, dst, n, mesh=None):
    agg = (_segsum_m(_gather_m(h, src, mesh), dst, n, mesh)
           + _segsum_m(_gather_m(h, dst, mesh), src, n, mesh))  # symmetrized
    z = (1.0 + lp["eps"]) * h + agg
    z = F.relu(z @ lp["w1"] + lp["b1"])
    return z @ lp["w2"] + lp["b2"]


def _gat_layer(h, lp, s2, d2, n, mesh=None):
    """``s2``/``d2``: the layouts of both directions of every undirected
    edge (sources, destinations)."""
    d = h.shape[-1]
    nh, dh = lp["a_src"].shape
    q = (h @ lp["w"].reshape(d, nh * dh)).reshape(n, nh, dh)
    es = torch.einsum("nhd,hd->nh", q, lp["a_src"])
    ed = torch.einsum("nhd,hd->nh", q, lp["a_dst"])
    logit = F.leaky_relu(_gather_m(es, s2, mesh) + _gather_m(ed, d2, mesh), 0.2)  # [2E, H]
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
    if mesh is not None:  # the max over every rank's incoming edges
        from repro_torch.sharding.collectives import all_reduce_axes

        mx = all_reduce_axes(mx.contiguous(), mesh, mesh.axis_names, "max")
    ex = torch.exp(logit - _gather_m(mx, d2, mesh))
    denom = _segsum_m(ex, d2, n, mesh) + 1e-9
    alpha = ex / _gather_m(denom, d2, mesh)
    msg = alpha[:, :, None] * _gather_m(q, s2, mesh)
    out = _segsum_m(msg.reshape(-1, nh * dh), d2, n, mesh)
    return F.elu(out)


_EDGE_MLP = ("we1", "be1", "we2", "be2")


def _mpnn_layer(h, e_feat, lp, src, dst, n, mesh=None):
    lp = _edge_params(lp, _EDGE_MLP, mesh)
    z = torch.cat([e_feat, _gather_m(h, src, mesh), _gather_m(h, dst, mesh)], dim=-1)
    e_new = F.relu(z @ lp["we1"] + lp["be1"]) @ lp["we2"] + lp["be2"]
    e_feat = e_feat + e_new
    agg = _segsum_m(e_feat, dst, n, mesh) + _segsum_m(e_feat, src, n, mesh)
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


def whole_nodes(batch: dict, place) -> dict:
    """The batch with every input but the edges made whole (gathered from
    the ranks' blocks) and the edges this rank's."""
    from repro_torch.sharding.params import gather_tree

    specs = place.batch_specs
    out = {}
    for k, v in batch.items():
        if k == "edges":
            out[k] = local_edges(v, specs.get(k), place.mesh)
        else:
            out[k] = gather_tree(v, specs.get(k) or (), place.mesh)
    return out


def forward(cfg: GNNConfig, params, batch, place=None):
    """batch: feats [N, d_feat], edges [E, 2] (trash id = N), plus
    graph_ids [N] for graph_class. Returns [N, n_out] (or [B, n_out]).
    With ``place`` the node inputs are whole and the edges this rank's
    (``whole_nodes``); every rank returns the whole output."""
    mesh = place.mesh if place is not None and place.mesh.size > 1 else None
    feats, edges = batch["feats"], batch["edges"]
    n = feats.shape[0]
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
        h_ext = torch.cat([h, torch.zeros((1, h.shape[1]), dtype=h.dtype, device=h.device)])
        # Ids above n read h_ext's zero row (gather_rows clamps them to it).
        e_feat = torch.cat([_gather_m(h_ext, segment_ops.segment_layout(lay.ids, n + 1), mesh)
                            for lay in (src, dst)], dim=-1)
        ep = _edge_params(params, ("edge_in_w", "edge_in_b"), mesh)
        e_feat = F.relu(e_feat @ ep["edge_in_w"] + ep["edge_in_b"])
        for i in range(n_layers):
            lp = {k: v[i] for k, v in layers.items()}
            h, e_feat = layer_step(
                lambda h, e, lp=lp: _mpnn_layer(h, e, lp, src, dst, n, mesh), h, e_feat)
    else:
        layer = _gin_layer if cfg.arch == "gin" else _gat_layer
        for i in range(n_layers):
            lp = {k: v[i] for k, v in layers.items()}
            h = layer_step(lambda h, lp=lp: h + layer(h, lp, src, dst, n, mesh), h)

    if cfg.task == "graph_class":
        pooled = segment_ops.segment_sum_edges(h, batch["graph_ids"], batch["labels"].shape[0])
        return pooled @ params["out_w"] + params["out_b"]
    return h @ params["out_w"] + params["out_b"]


def gnn_loss(cfg: GNNConfig, params, batch, place=None):
    """Masked cross-entropy (``node_class``, ``graph_class``) or masked
    squared error (``node_reg``). With ``place`` every rank computes the
    whole loss from its blocks of the batch (``whole_nodes``)."""
    if place is not None:
        batch = whole_nodes(batch, place)
    out = forward(cfg, params, batch, place).to(torch.float32)
    labels, mask = batch["labels"], batch["mask"]
    if cfg.task == "node_reg":
        err = torch.square(out - labels) * mask[:, None]
        return torch.sum(err) / torch.clamp(torch.sum(mask) * cfg.n_out, min=1.0)
    logz = torch.logsumexp(out, dim=-1)
    gold = torch.gather(out, -1, labels.long()[:, None])[:, 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
