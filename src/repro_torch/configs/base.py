"""Config system: ``ArchConfig`` (family, model hyperparameters, shape
cells, sharding profile name) and ``ShapeSpec`` (one dry-run cell).
``input_specs`` builds ``meta`` tensors, shape and dtype without storage,
for every model input of a cell: the port's stand-in for the reference's
abstract arrays. Nothing is allocated.

Padding policy (the reference's ``configs/base.py``): sharded dimensions
must divide by the mesh-axis extent, so vocabulary, node, edge and
candidate counts are padded up to mesh-friendly capacities here; true sizes
stay in the configs and the losses mask the padding.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | graph_train | serve | retrieval | bgv_*
    # LM
    seq_len: int = 0
    global_batch: int = 0
    # GNN (padded capacities)
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    n_out: int = 0
    task: str = ""
    n_graphs: int = 0
    # recsys
    n_candidates: int = 0
    # cell skipped (reason): still listed, never built
    skip: str = ""


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lm | gnn | recsys | bgv
    profile: str  # sharding profile name (the reference's sharding rules)
    model: Any  # LMConfig | GNNConfig | SASRecConfig | BGVDryConfig
    shapes: dict[str, ShapeSpec] = field(default_factory=dict)
    # train-time knobs of the reference's launcher (per arch)
    opt_state_bits: int = 32
    microbatch_train: int = 0
    train_param_dtype: torch.dtype | None = None  # None: the model's own param_dtype
    notes: str = ""

    def model_for(self, shape: ShapeSpec):
        """Per-shape model adjustments (GNN d_feat/n_out/task vary by cell)."""
        if self.family == "gnn":
            return replace(
                self.model,
                d_feat=shape.d_feat,
                n_out=shape.n_out,
                task=shape.task,
                remat=shape.n_nodes >= 100_000,
            )
        return self.model


# --------------------------------------------------------- LM shape builders

def lm_shapes(sub_quadratic: bool) -> dict[str, ShapeSpec]:
    shapes = {
        "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
        "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
        "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
    }
    if not sub_quadratic:
        shapes["long_500k"] = replace(
            shapes["long_500k"],
            skip="pure full-attention arch: long_500k requires sub-quadratic "
                 "attention (assignment rule; see DESIGN.md §5)",
        )
    return shapes


# -------------------------------------------------------- GNN shape builders

def gnn_shapes(arch: str) -> dict[str, ShapeSpec]:
    """The four assigned graph cells. Node/edge counts padded to 512-multiples;
    d_feat/n_out per shape from the public datasets backing each regime
    (cora / reddit / ogbn-products / molecules)."""
    reg = arch in ("meshgraphnet", "graphcast")
    n_out_sm, task_sm = (227, "node_reg") if arch == "graphcast" else ((3, "node_reg") if reg else (7, "node_class"))
    n_out_lg, task_lg = (227, "node_reg") if arch == "graphcast" else ((3, "node_reg") if reg else (41, "node_class"))
    n_out_pr, task_pr = (227, "node_reg") if arch == "graphcast" else ((3, "node_reg") if reg else (47, "node_class"))
    n_out_mol, task_mol = (2, "graph_class") if not reg else (1, "node_reg")
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "graph_train",
            n_nodes=pad_to(2708, 512), n_edges=pad_to(10556, 512),
            d_feat=1433, n_out=n_out_sm, task=task_sm,
        ),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg", "graph_train",
            # sampler capacity for batch_nodes=1024, fanout (15, 10)
            n_nodes=1024 * (1 + 15 + 150), n_edges=1024 * 15 + 1024 * 15 * 10,
            d_feat=602, n_out=n_out_lg, task=task_lg,
        ),
        "ogb_products": ShapeSpec(
            "ogb_products", "graph_train",
            n_nodes=pad_to(2_449_029, 512), n_edges=pad_to(61_859_140, 512),
            d_feat=100, n_out=n_out_pr, task=task_pr,
        ),
        "molecule": ShapeSpec(
            "molecule", "graph_train",
            n_nodes=pad_to(128 * 30, 512), n_edges=pad_to(128 * 64, 512),
            d_feat=16, n_out=n_out_mol, task=task_mol, n_graphs=128,
        ),
    }


# ----------------------------------------------------- recsys shape builders

def recsys_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", global_batch=65536),
        "serve_p99": ShapeSpec("serve_p99", "serve", global_batch=512),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", global_batch=262144),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval", global_batch=1,
            n_candidates=pad_to(1_000_000, 512),
        ),
    }


# -------------------------------------------------------------- input specs

def meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a tensor on the ``meta`` device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors for every model input of this cell."""
    i32, f32 = torch.int32, torch.float32
    if arch.family == "lm":
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": meta((b, s), i32), "loss_mask": meta((b, s), f32)}
        if shape.kind == "prefill":
            return {"tokens": meta((b, s), i32)}
        if shape.kind == "decode":
            return {"tokens": meta((b, 1), i32), "cur_len": meta((), i32)}
    if arch.family == "gnn":
        spec = {
            "feats": meta((shape.n_nodes, shape.d_feat), f32),
            "edges": meta((shape.n_edges, 2), i32),
        }
        if shape.task == "graph_class":
            spec["graph_ids"] = meta((shape.n_nodes,), i32)
            spec["labels"] = meta((shape.n_graphs,), i32)
            spec["mask"] = meta((shape.n_graphs,), f32)
        elif shape.task == "node_reg":
            spec["labels"] = meta((shape.n_nodes, shape.n_out), f32)
            spec["mask"] = meta((shape.n_nodes,), f32)
        else:
            spec["labels"] = meta((shape.n_nodes,), i32)
            spec["mask"] = meta((shape.n_nodes,), f32)
        return spec
    if arch.family == "recsys":
        s = arch.model.seq_len
        b = shape.global_batch
        if shape.kind == "train":
            return {"seq": meta((b, s), i32), "pos": meta((b, s), i32),
                    "neg": meta((b, s), i32)}
        if shape.kind == "serve":
            return {"seq": meta((b, s), i32)}
        if shape.kind == "retrieval":
            return {"seq": meta((1, s), i32),
                    "candidates": meta((shape.n_candidates,), i32)}
    raise ValueError(f"no input spec for {arch.name}/{shape.name}")
