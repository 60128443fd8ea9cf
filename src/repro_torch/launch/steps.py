"""Step builders: one function and its abstract inputs (``meta`` tensors)
per (arch × shape) cell, with the roofline metadata the reference's
builders give (``launch/steps.py`` there).

Every cell builds: the training cells (the LMs' ``train_*``, every GNN
cell, SASRec's ``train_batch``) as ``train.make_train_step`` over the
family's loss, taking ``(params, opt_state, batch)`` and updating both in
place (the reference donates them, ``donate=(0, 1)``); the rest as the
prefill, decode, serve and retrieval steps and the BigGraphVis cells.

With a ``launch.mesh.ModelMesh`` of D ranks (``mesh``), every rank calls
the step on its blocks: ``in_specs`` holds the port's spec for every input
leaf (``sharding.rules.spec_for`` over the arch's profile, the reference's
``params_shardings``/``shardings_for_axes``/batch placements), and
``sharding.params.shard_tree`` cuts them. The steps:
* ``train`` (LMs, profile "tp"), ``graph_train`` (GNNs, "gnn") and
  ``train_batch`` (SASRec, "recsys") — the family's loss on the rank's
  blocks (``models``' mesh forms) under ``make_train_step(..., mesh=)``;
  the batch rows split over ("pod", "data") where they divide
  (``_shard_batch_dim``), the GNN inputs over every axis, and the GNN node
  state kept as each rank's block of rows between layers;
* ``bgv_detect`` — the edges split over every axis: the one SCoDA block
  of all e edges gathered whole (``sharded_scoda_update``), then
  ``cms.sharded_update``; bitwise the one-rank step;
* ``bgv_layout`` — node rows split over every axis: each rank computes
  the forces on its rows (K2's and K6's row entries), one all-gather
  assembles them (``fa2.force_pass``'s split); bitwise the one-rank step.
* ``prefill`` and ``decode`` (LMs, "tp") — the mesh forward without the
  loss, and the decode step on the reference's sequence-sharded KV cache
  (``P(None, bdim, "model", None, None)``: split-K attention across the
  "model" ranks);
* ``serve`` and ``retrieval`` (SASRec, "recsys") — the scores against the
  rank's block of the item table; the candidates and their scores split
  over every axis.
Train and prefill split the residual stream's sequence over "model" where
it divides (``Placement.seq_axis``, the reference's rule). Returned
tensors are the rank's blocks of the outputs, as the inputs (a train
step's parameters and state are its inputs, updated in place); a serving
step's ``out_specs`` holds their specs, the reference's ``out_shardings``.
``mesh=None`` is one device.
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
from repro_torch.models.param import abstract_params, logical_axes, param_count
from repro_torch.sharding.params import Placement
from repro_torch.sharding.rules import P, filter_spec, params_shardings, shardings_for_axes
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import TrainConfig, make_train_step


@dataclass
class BuiltStep:
    fn: Callable
    abstract_args: tuple  # ``meta`` tensors (nested dicts for parameters), whole shapes
    meta: dict  # roofline metadata (trip counts, model flops, ...)
    in_specs: tuple | None = None  # the spec of every input leaf (mesh only)
    place: Placement | None = None  # the model path's placement (model cells)
    out_specs: object = None  # the spec of every output leaf (serving cells, mesh only)


def _check_mesh(mesh) -> None:
    if mesh is not None and not (hasattr(mesh, "axis_names") and hasattr(mesh, "shape")
                                 and hasattr(mesh, "coords")):
        raise ValueError(f"build_step: mesh must be None or a launch.mesh.ModelMesh, got "
                         f"{type(mesh).__name__}")


def _specs(shardings):
    """``NamedSharding`` tree → spec tree."""
    if isinstance(shardings, dict):
        return {k: _specs(v) for k, v in shardings.items()}
    return shardings.spec


def _extent(mesh, axes) -> int:
    e = 1
    for a in (axes or ()):
        e *= mesh.shape[a]
    return e


def _shard_batch_dim(mesh, b: int):
    """("pod", "data") where present, if their extent divides the batch and
    exceeds 1; else None (the batch replicated)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if (b % _extent(mesh, axes) == 0 and _extent(mesh, axes) > 1) else None


def _batch_specs(mesh, abstract: dict, leading) -> dict:
    """dim 0 of every batch input over ``leading`` where it divides."""
    out = {}
    for k, v in abstract.items():
        if v.dim() == 0:
            out[k] = P()
        else:
            lead = leading if (leading and v.shape[0] % _extent(mesh, leading) == 0) else None
            out[k] = P(lead, *([None] * (v.dim() - 1)))
    return out


def _check_state_specs(p_specs, o_specs, acfg) -> None:
    """The state's blocks are the parameters' (``optimizer.state_specs``);
    the optimizer relies on it."""
    def walk(ps, os_):
        if isinstance(ps, dict):
            for k in ps:
                walk(ps[k], os_[k])
            return
        want = opt.state_specs(ps, acfg)
        if _flat(want) != _flat(os_):
            raise NotImplementedError(f"optimizer state blocks {os_} differ from the "
                                      f"parameter's {ps}")

    walk(p_specs, o_specs["mv"])


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tuple(tree)]


def _seq_axis(mesh, shape: ShapeSpec):
    """"model" for train and prefill where the sequence divides over it
    (the reference's sequence-parallel rule, ``steps.py:125``), else None."""
    if shape.kind in ("train", "prefill") and shape.seq_len % mesh.shape.get("model", 1) == 0:
        return "model"
    return None


def _train_step(loss_fn, aparams, abstract_batch, info, acfg: opt.AdamWConfig,
                microbatch: int = 0, mesh=None, specs=None, profile: str = "",
                batch_specs=None, batch_axes=(), seq_axis=None) -> BuiltStep:
    tcfg = TrainConfig(adamw=acfg, microbatch=microbatch)
    aopt = opt.abstract_opt_state(aparams, acfg)
    abstract = (aparams, aopt, abstract_batch)
    if mesh is None:
        return BuiltStep(make_train_step(loss_fn, tcfg), abstract, info)
    p_specs = _specs(params_shardings(specs, profile, mesh))
    o_axes = opt.opt_logical_axes(logical_axes(specs), acfg)
    o_specs = _specs(shardings_for_axes(aopt, o_axes, profile, mesh))
    _check_state_specs(p_specs, o_specs, acfg)
    place = Placement(mesh, p_specs, tuple(batch_axes or ()), batch_specs=batch_specs,
                      seq_axis=seq_axis)
    fn = make_train_step(functools.partial(loss_fn, place=place), tcfg, mesh=place)
    return BuiltStep(fn, abstract, info, (p_specs, o_specs, batch_specs), place)


def _serve_place(arch: ArchConfig, shape: ShapeSpec, specs, mesh, abstract_batch,
                 seq_axis=None):
    """``(placement, parameter specs, batch specs, bdim)`` of a serving cell."""
    p_specs = _specs(params_shardings(specs, arch.profile, mesh))
    bdim = _shard_batch_dim(mesh, shape.global_batch)
    b_specs = _batch_specs(mesh, abstract_batch, bdim)
    return (Placement(mesh, p_specs, tuple(bdim or ()), batch_specs=b_specs,
                      seq_axis=seq_axis), p_specs, b_specs, bdim)


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
    _check_mesh(mesh)
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
        bdim = _shard_batch_dim(mesh, shape.global_batch) if mesh is not None else None
        return _train_step(functools.partial(tfm.lm_loss, cfg), aparams, abstract_batch, info,
                           opt.AdamWConfig(state_bits=arch.opt_state_bits),
                           arch.microbatch_train, mesh, specs, arch.profile,
                           _batch_specs(mesh, abstract_batch, bdim) if mesh else None, bdim,
                           _seq_axis(mesh, shape) if mesh else None)
    acache = (tfm.abstract_kv_cache(cfg, shape.global_batch, shape.seq_len)
              if shape.kind == "decode" else None)
    if mesh is None:
        if shape.kind == "prefill":
            return BuiltStep(tfm.make_prefill(cfg), (aparams, abstract_batch), info)
        return BuiltStep(tfm.make_decode_step(cfg), (aparams, acache, abstract_batch), info)
    place, p_specs, b_specs, bdim = _serve_place(arch, shape, specs, mesh, abstract_batch,
                                                 _seq_axis(mesh, shape))
    logits = filter_spec(P(bdim, None, "model" if place.tp(p_specs["unembed"], 1) else None),
                         mesh)
    if shape.kind == "prefill":
        return BuiltStep(tfm.make_prefill(cfg, place), (aparams, abstract_batch), info,
                         (p_specs, b_specs), place, logits)
    if shape.seq_len % mesh.extent("model"):
        raise ValueError(f"build_step: the cache's {shape.seq_len} positions do not split "
                         f"over \"model\" ({mesh.extent('model')})")
    c_spec = filter_spec(P(None, bdim, "model", None, None), mesh)
    c_specs = {k: c_spec for k in acache}
    return BuiltStep(tfm.make_decode_step(cfg, place), (aparams, acache, abstract_batch), info,
                     (p_specs, c_specs, b_specs), place, (logits, c_specs))


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
    """Every GNN cell is a training cell (``graph_train``). On a mesh every
    input whose dim 0 divides by the whole mesh is split over every axis
    (the edges, and the node inputs: the reference's ``b_shard``), else over
    the batch axes where they divide, else replicated. The loss keeps the
    node state split over every axis as the reference's constraint does
    (``models.gnn``: a rank's block of c = ceil(N / D) rows, node inputs
    not split so cut to it) and the edges split; every rank returns the
    global loss, and every parameter's gradient is summed inside the loss
    (``copy_to``), so no batch axis sums either."""
    _check_mesh(mesh)
    cfg = arch.model_for(shape)
    specs = gnn_lib.param_specs(cfg)
    info = _gnn_flops_meta(cfg, shape)
    info["param_count"] = param_count(specs)
    abstract_batch = input_specs(arch, shape)
    b_specs = None
    if mesh is not None:
        every = tuple(mesh.axis_names)
        b_specs = {}
        for k, v in abstract_batch.items():
            rest = [None] * (v.dim() - 1)
            bdim = _shard_batch_dim(mesh, v.shape[0]) if v.dim() else None
            if v.dim() and v.shape[0] % _extent(mesh, every) == 0:
                b_specs[k] = filter_spec(P(every, *rest), mesh)
            elif bdim:
                b_specs[k] = P(bdim, *rest)
            else:
                b_specs[k] = P(*([None] * v.dim()))
    return _train_step(functools.partial(gnn_lib.gnn_loss, cfg), abstract_params(specs),
                       abstract_batch, info, opt.AdamWConfig(), 0, mesh, specs, arch.profile,
                       b_specs, ())


# -------------------------------------------------------------- recsys cells

def build_recsys_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    _check_mesh(mesh)
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
        bdim = _shard_batch_dim(mesh, b) if mesh is not None else None
        return _train_step(functools.partial(sas_lib.sasrec_loss, cfg), aparams,
                           abstract_batch, info, opt.AdamWConfig(), 0, mesh, specs,
                           arch.profile,
                           _batch_specs(mesh, abstract_batch, bdim) if mesh else None, bdim)
    if shape.kind == "serve":
        info["model_flops"] = float(enc_flops + b * 2 * d * v)
        if mesh is None:
            return BuiltStep(sas_lib.make_serve_step(cfg), (aparams, abstract_batch), info)
        place, p_specs, b_specs, bdim = _serve_place(arch, shape, specs, mesh, abstract_batch)
        scores = filter_spec(P(bdim, "model" if place.tp(p_specs["item_embed"], 0) else None),
                             mesh)
        return BuiltStep(sas_lib.make_serve_step(cfg, place), (aparams, abstract_batch), info,
                         (p_specs, b_specs), place, scores)
    info["model_flops"] = float(enc_flops + 2 * d * shape.n_candidates)
    if mesh is None:
        return BuiltStep(sas_lib.make_retrieval_step(cfg), (aparams, abstract_batch), info)
    if shape.n_candidates % mesh.size:
        raise ValueError(f"build_step: {shape.n_candidates} candidates do not split over "
                         f"{mesh.size} ranks")
    place, p_specs, b_specs, _ = _serve_place(arch, shape, specs, mesh, abstract_batch)
    every = filter_spec(P(tuple(mesh.axis_names)), mesh)
    b_specs["candidates"] = every
    return BuiltStep(sas_lib.make_retrieval_step(cfg, place), (aparams, abstract_batch), info,
                     (p_specs, b_specs), place, every)


# ----------------------------------------------------------------- BGV cells

def build_bgv_step(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> BuiltStep:
    """The paper's pipeline as one step (``configs/biggraphvis.py``):
    detect is one SCoDA round in one block plus the CMS sketch (K8 on the
    card); layout is one ``fa2.step`` (K2, or K5–K7 for the grid cells,
    which take ``(cell, order)`` from ``kernels/grid`` ``bin_and_sort``:
    the caller refreshes them on its own cadence). With a mesh, the forms
    of the module docstring, on the rank's blocks."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.core.scoda import ScodaConfig, scoda_update, sharded_scoda_update
    from repro_torch.sharding.collectives import all_gather_rows

    _check_mesh(mesh)
    n, e = shape.n_nodes, shape.n_edges
    i32, f32 = torch.int32, torch.float32
    d = mesh.size if mesh is not None else 1
    every = tuple(mesh.axis_names) if mesh is not None else ()
    if d > 1 and (n % d or e % d):
        raise ValueError(f"build_bgv_step: {n} nodes and {e} edges do not split over {d} ranks")

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

        def detect_step_sharded(com, deg, edges):
            # The rank's rows of the one block of all e edges: gathered
            # whole, in order, inside the update.
            com, deg = sharded_scoda_update((com, deg), edges, 16, scoda_cfg, mesh)
            sketch = cms_lib.init_sketch(cms_cfg, device=com.device)
            sketch = cms_lib.sharded_update(sketch, com[:-1], deg[:-1].to(f32), cms_cfg, mesh)
            return com, deg, sketch

        abstract = (meta((n + 1,), i32), meta((n + 1,), i32), meta((e, 2), i32))
        info = {"model_flops": float(30 * e), "scan_trip_count": 1, "tokens": e}
        if mesh is None:
            return BuiltStep(detect_step, abstract, info)
        specs = (P(None), P(None), filter_spec(P(every, None), mesh))
        return BuiltStep(detect_step_sharded if d > 1 else detect_step, abstract, info, specs)

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

    def layout_step_sharded(*blocks):
        # Every input gathered whole (a concatenation: the same bits); the
        # forces on the rank's rows as ``fa2.step`` sums them (gravity,
        # the attraction's rows, K2's or K6's row entry), one all-gather of
        # the forces, the speed controller on the whole arrays.
        pos, prev_f, mass, radii, edges, weights, *grid = [
            all_gather_rows(x, mesh) for x in blocks]
        cell, order = grid if grid else (None, None)
        nl = n // d
        i0 = mesh.rank * nl

        def gather(x):
            return all_gather_rows(x, mesh)

        f = fa2._gravity(pos[i0:i0 + nl], mass[i0:i0 + nl], cfg)
        f = f + fa2._attraction(pos, edges, weights, n)[i0:i0 + nl]
        f = f + fa2._repulsion_forces(pos, mass, radii, cfg, cell=cell, order=order,
                                      rows=(i0, nl), gather=gather)
        state = (pos, prev_f, torch.ones((), dtype=pos.dtype, device=pos.device))
        (pos, f, _), _ = fa2._apply_speed_guarded(state, gather(f), mass, cfg)
        return pos[i0:i0 + nl], f[i0:i0 + nl]

    abstract = (meta((n, 2), f32), meta((n, 2), f32), meta((n,), f32), meta((n,), f32),
                meta((e, 2), i32), meta((e,), f32))
    if grid_cell:
        abstract = abstract + (meta((n,), i32), meta((n,), i32))
    info = {"model_flops": float(10.0 * n * n + 20 * e), "scan_trip_count": 1, "tokens": n}
    if mesh is None:
        return BuiltStep(layout_step, abstract, info)
    specs = tuple(filter_spec(P(every, *([None] * (a.dim() - 1))), mesh) for a in abstract)
    return BuiltStep(layout_step_sharded if d > 1 else layout_step, abstract, info, specs)


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
