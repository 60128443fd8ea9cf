"""Step builders: one function and its abstract inputs (``meta`` tensors)
per (arch × shape) cell, with the roofline metadata the reference's
builders give (``launch/steps.py`` there).

Every cell builds: the training cells (the LMs' ``train_*``, every GNN
cell, SASRec's ``train_batch``) as ``train.make_train_step`` over the
family's loss, taking ``(params, opt_state, batch)`` and updating both in
place (the reference donates them, ``donate=(0, 1)``); the rest as the
prefill, decode, serve and retrieval steps and the BigGraphVis cells.

The reference also lowers each step onto a TPU device mesh with
per-input shardings; that has no meaning on one card, so ``mesh`` must be
None and anything else raises. The multi-device cells are not ported.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, input_specs, meta
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import sasrec as sas_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.param import abstract_params, param_count
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import TrainConfig, make_train_step


@dataclass
class BuiltStep:
    fn: Callable
    abstract_args: tuple  # ``meta`` tensors (nested dicts for parameters)
    meta: dict  # roofline metadata (trip counts, model flops, ...)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError(
            "build_step: mesh must be None; the port runs a cell on one device "
            "and has no lowering onto a device mesh"
        )


def _train_step(loss_fn, aparams, abstract_batch, info, acfg: opt.AdamWConfig,
                microbatch: int = 0) -> BuiltStep:
    fn = make_train_step(loss_fn, TrainConfig(adamw=acfg, microbatch=microbatch))
    return BuiltStep(fn, (aparams, opt.abstract_opt_state(aparams, acfg), abstract_batch), info)


# ------------------------------------------------------------------ LM cells

def _lm_flops_meta(cfg: tfm.LMConfig, shape: ShapeSpec) -> dict:
    """Analytic MODEL_FLOPS: 6·N_active·D for train, 2·N_active·D for fwd."""
    d, nl = cfg.d_model, cfg.n_layers
    att = d * cfg.n_heads * cfg.head_dim + 2 * d * cfg.n_kv_heads * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d
    if cfg.moe is None:
        mlp = 3 * d * cfg.d_ff
    else:
        m = cfg.moe
        mlp = m.top_k * 3 * d * m.d_ff_expert + m.n_shared * 3 * d * m.d_ff_expert \
            + d * m.n_experts
    n_active = nl * (att + mlp) + 2 * d * cfg.vocab_padded
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    attn_extra = 2 * 2 * shape.seq_len * cfg.n_heads * cfg.head_dim \
        * (0.5 if shape.kind != "decode" else 1.0)
    return {
        "model_flops": float(mult * n_active * tokens + mult / 2 * attn_extra * tokens * nl),
        "n_params_active": float(n_active),
        "scan_trip_count": nl,
        "tokens": tokens,
    }


def build_lm_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    _no_mesh(mesh)
    cfg = arch.model
    if shape.kind == "train" and arch.train_param_dtype is not None:
        cfg = replace(cfg, param_dtype=arch.train_param_dtype)
    if shape.kind in ("prefill", "decode"):
        # Serving weights are stored in the activation dtype.
        cfg = replace(cfg, param_dtype=cfg.act_dtype)
    specs = tfm.param_specs(cfg)
    aparams = abstract_params(specs)
    abstract_batch = input_specs(arch, shape)
    info = _lm_flops_meta(cfg, shape)
    info["param_count"] = param_count(specs)
    if shape.kind == "train":
        return _train_step(functools.partial(tfm.lm_loss, cfg), aparams, abstract_batch, info,
                           opt.AdamWConfig(state_bits=arch.opt_state_bits),
                           arch.microbatch_train)
    if shape.kind == "prefill":
        return BuiltStep(tfm.make_prefill(cfg), (aparams, abstract_batch), info)
    acache = tfm.abstract_kv_cache(cfg, shape.global_batch, shape.seq_len)
    return BuiltStep(tfm.make_decode_step(cfg), (aparams, acache, abstract_batch), info)


# ----------------------------------------------------------------- GNN cells

def _gnn_flops_meta(cfg: gnn_lib.GNNConfig, shape: ShapeSpec) -> dict:
    d = cfg.d_hidden
    n, e = shape.n_nodes, shape.n_edges
    if cfg.arch in ("meshgraphnet", "graphcast"):
        per_layer = e * (3 * d * d + d * d) * 2 + n * (2 * d * d + d * d) * 2
    elif cfg.arch == "gin":
        per_layer = n * 2 * d * d * 2 + e * 2 * d
    else:  # gat
        per_layer = n * 2 * d * d + e * 8 * d
    fwd = cfg.n_layers * per_layer + n * 2 * (shape.d_feat + shape.n_out) * d
    return {
        "model_flops": float(3 * fwd),  # train = fwd + 2×bwd
        "scan_trip_count": cfg.n_layers,
        "tokens": n,
    }


def build_gnn_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    """Every GNN cell is a training cell (``graph_train``)."""
    _no_mesh(mesh)
    cfg = arch.model_for(shape)
    specs = gnn_lib.param_specs(cfg)
    info = _gnn_flops_meta(cfg, shape)
    info["param_count"] = param_count(specs)
    return _train_step(functools.partial(gnn_lib.gnn_loss, cfg), abstract_params(specs),
                       input_specs(arch, shape), info, opt.AdamWConfig())


# -------------------------------------------------------------- recsys cells

def build_recsys_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    _no_mesh(mesh)
    cfg: sas_lib.SASRecConfig = arch.model
    specs = sas_lib.param_specs(cfg)
    aparams = abstract_params(specs)
    abstract_batch = input_specs(arch, shape)
    d, s, v = cfg.embed_dim, cfg.seq_len, cfg.n_items
    b = shape.global_batch
    enc_flops = b * s * (4 * d * d + 2 * d * d + 2 * s * d) * cfg.n_blocks
    info = {"scan_trip_count": cfg.n_blocks, "param_count": param_count(specs),
            "tokens": b * s}
    if shape.kind == "train":
        info["model_flops"] = float(3 * (enc_flops + b * s * 2 * 2 * d))
        return _train_step(functools.partial(sas_lib.sasrec_loss, cfg), aparams,
                           abstract_batch, info, opt.AdamWConfig())
    if shape.kind == "serve":
        info["model_flops"] = float(enc_flops + b * 2 * d * v)
        return BuiltStep(sas_lib.make_serve_step(cfg), (aparams, abstract_batch), info)
    info["model_flops"] = float(enc_flops + 2 * d * shape.n_candidates)
    return BuiltStep(sas_lib.make_retrieval_step(cfg), (aparams, abstract_batch), info)


# ----------------------------------------------------------------- BGV cells

def build_bgv_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    """The paper's pipeline as one step (``configs/biggraphvis.py``):
    detect is one SCoDA round in one block plus the CMS sketch (K8 on the
    card); layout is one ``fa2.step`` (K2, or K5–K7 for the grid cells,
    which take ``(cell, order)`` from ``kernels/grid`` ``bin_and_sort``:
    the caller refreshes them on its own cadence)."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.core.scoda import ScodaConfig, scoda_update

    _no_mesh(mesh)
    n, e = shape.n_nodes, shape.n_edges
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "bgv_detect":
        cms_cfg = cms_lib.CMSConfig(rows=4, cols=shape.n_out)
        scoda_cfg = ScodaConfig(
            degree_threshold=16, rounds=1, block_size=e, tie_break="join",
            degree_update="scoda", exact_block_degrees=False,
            conflict="min", propagate_jumps=0,
        )

        def detect_step(com, deg, edges):
            com, deg = scoda_update((com, deg), edges, 16, scoda_cfg)
            sketch = cms_lib.init_sketch(cms_cfg, device=com.device)
            sketch = cms_lib.update(sketch, com[:-1], deg[:-1].to(f32), cms_cfg)
            return com, deg, sketch

        abstract = (meta((n + 1,), i32), meta((n + 1,), i32), meta((e, 2), i32))
        info = {"model_flops": float(30 * e), "scan_trip_count": 1, "tokens": e}
        return BuiltStep(detect_step, abstract, info)

    model = arch.model
    cfg = fa2.FA2Config(
        iterations=1, use_radii=True,
        repulsion=getattr(model, "layout_repulsion", "exact"),
        grid_size=getattr(model, "layout_grid_size", 64),
        grid_window=getattr(model, "layout_grid_window", 32),
    )
    grid_cell = cfg.repulsion in ("grid", "grid_pallas")

    def layout_step(pos, prev_f, mass, radii, edges, weights, cell=None, order=None):
        state = (pos, prev_f, torch.ones((), dtype=pos.dtype, device=pos.device))
        (pos, f, _), _ = fa2.step(state, edges, weights, mass, radii, cfg, n,
                                  cell=cell, order=order)
        return pos, f

    abstract = (meta((n, 2), f32), meta((n, 2), f32), meta((n,), f32), meta((n,), f32),
                meta((e, 2), i32), meta((e,), f32))
    if grid_cell:
        abstract = abstract + (meta((n,), i32), meta((n,), i32))
    info = {"model_flops": float(10.0 * n * n + 20 * e), "scan_trip_count": 1, "tokens": n}
    return BuiltStep(layout_step, abstract, info)


def build_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    if arch.family == "lm":
        return build_lm_step(arch, shape, mesh)
    if arch.family == "recsys":
        return build_recsys_step(arch, shape, mesh)
    if arch.family == "gnn":
        return build_gnn_step(arch, shape, mesh)
    if arch.family == "bgv":
        return build_bgv_step(arch, shape, mesh)
    raise ValueError(arch.family)
