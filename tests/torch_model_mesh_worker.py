"""The cases of ``tests/test_torch_model_mesh.py`` and the rank side of them.

Both packages build their configs from the plain descriptions here
(``CASES``, ``lm_config``, ...), and ``tests/torch_model_mesh_ref.py`` runs
the reference's side in a process of its own. Ranks are fresh processes
that import this module, so it imports only ``numpy``, and ``torch`` and
``repro_torch`` inside the functions that use them (never ``jax`` or the
reference package). ``run_all`` runs
every case of a world size on the rank's meshes and writes the rank's
results to ``{out}/rank{r}.pkl``.
"""
from __future__ import annotations

import functools
import math
import pickle
from dataclasses import replace

import numpy as np

# AdamW's lr by family. The LMs and SASRec take a warm-up's lr: their
# attention logits are sharp at the reference's fan-in (fault R6), so a
# rounding-level difference in the first step's parameters moves the
# second step's gradients apart in proportion to lr (at 1e-3 SASRec's
# grad norm by 5e-4 between the two packages, one rank each).
LR = {"lm": 1e-5, "recsys": 1e-5, "gnn": 1e-3}
STEPS = 2
LM_BATCH, LM_SEQ = (4, 16)
GNN_NODES, GNN_EDGES = 40, 96
# GNN cases of other sizes: N that does not divide over the 4 ranks (the
# node blocks of c = ceil(N / 4) rows, the last short; or empty). The
# graph-level case pools GNN_GRAPHS graphs.
GNN_SIZES = {"gat-uneven-2x2": (38, 96), "gin-empty-2x2": (9, 96)}
GNN_GRAPHS = 4
SAS_BATCH = 8
# A train step case: (name, family, config, mesh shape, state bits,
# compress_grads, held against): "ref" the reference's sharded step, "one"
# the port's one-rank step (the reference's compiles take ≈ 5 s a case on
# the CPU, so the cases it runs are few).
CASES = [
    ("dense-8bit-1x2", "lm", "dense", (1, 2), 8, False, "ref"),
    ("dense-compress-2x1", "lm", "dense", (2, 1), 32, True, "ref"),
    ("granite-1x2", "lm", "granite", (1, 2), 32, False, "ref"),
    ("granite-2x2", "lm", "granite", (2, 2), 32, False, "ref"),
    ("gin-2x2", "gnn", "gin", (2, 2), 32, False, "ref"),
    ("sasrec-2x2", "recsys", "sasrec", (2, 2), 32, False, "ref"),
    ("dense-2x2", "lm", "dense", (2, 2), 32, False, "one"),
    ("dense-8bit-compress-2x2", "lm", "dense", (2, 2), 8, True, "one"),
    ("moe-shared-8bit-1x2", "lm", "moe-shared", (1, 2), 8, True, "one"),
    ("gat-2x2", "gnn", "gat", (2, 2), 32, False, "one"),
    ("graphcast-2x1", "gnn", "graphcast", (2, 1), 32, False, "one"),
    ("sasrec-2x1", "recsys", "sasrec", (2, 1), 32, False, "one"),
    ("gat-uneven-2x2", "gnn", "gat", (2, 2), 32, False, "one"),
    ("gin-empty-2x2", "gnn", "gin", (2, 2), 32, False, "one"),
    ("gin-graph-2x2", "gnn", "gin-graph", (2, 2), 32, False, "one"),
]
# The reference's cases in groups of about equal compile time, one process
# each; the first also runs the MoE cases and the blocks.
REF_GROUPS = [["dense-8bit-1x2", "gin-2x2"], ["dense-compress-2x1", "sasrec-2x2"],
              ["granite-1x2", "granite-2x2"]]
# moe_mlp_shmap: (name, mesh shape, capacity_local); 2 drops tokens, 64 none.
MOE_CASES = [("moe-1x2-drop", (1, 2), 2), ("moe-1x2-all", (1, 2), 64),
             ("moe-2x2-drop", (2, 2), 2), ("moe-2x2-all", (2, 2), 64)]
MOE_SHAPE = (4, 8, 16, 4, 8, 2)  # B, S, D, E, F, top_k
# The BigGraphVis cells, cut: (name, kind, repulsion, n, e, cms cols).
BGV_CASES = [("detect", "bgv_detect", "exact", 512, 2048, 64),
             ("layout-exact", "bgv_layout", "exact", 512, 1024, 0),
             ("layout-grid", "bgv_layout", "grid", 512, 1024, 0)]


def world_of(shape) -> int:
    return math.prod(shape)


def lm_config(name: str, ns):
    """The LM config of ``name`` from a configs namespace (``smoke_lm`` and
    ``get_config``) and a float32 dtype of its package."""
    smoke_lm, get_config, f32 = ns
    if name == "dense":
        return smoke_lm()
    if name == "moe-shared":
        return smoke_lm(moe=True)
    base = get_config("granite-moe-1b-a400m").model  # tests/test_sharding_and_launch.py's
    return replace(base, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                   d_ff=64, vocab=97, vocab_padded=112, q_chunk=0, act_dtype=f32,
                   moe=replace(base.moe, n_experts=4, top_k=2, d_ff_expert=32))


def np_params(specs_leaves, seed: int) -> dict:
    """``{path: array}`` for ``[(path, shape, init)]``: the reference's init
    rule (fan-in scaled normal, normal × 0.02, zeros) from a numpy
    generator, leaves in the order given."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape, init in specs_leaves:
        if init == "zeros":
            out[path] = np.zeros(shape, np.float32)
            continue
        x = rng.standard_normal(shape).astype(np.float32)
        if init == "scaled":
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            out[path] = (x / np.float32(math.sqrt(max(fan_in, 1)))).astype(np.float32)
        else:
            out[path] = (x * np.float32(0.02)).astype(np.float32)
    return out


def spec_leaves(specs, prefix=()):
    """``[(path, shape, init)]`` of a nested dict of ``ParamSpec``s, keys sorted."""
    out = []
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            out += spec_leaves(v, prefix + (k,))
        else:
            out.append(("/".join(prefix + (k,)), tuple(v.shape), v.init))
    return out


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def gnn_size(name: str | None) -> tuple:
    """(nodes, edges) of a GNN case."""
    return GNN_SIZES.get(name, (GNN_NODES, GNN_EDGES))


def batch_for(family: str, cfg, seed: int, name: str | None = None) -> dict:
    rng = np.random.default_rng(seed)
    if family == "lm":
        return {"tokens": rng.integers(1, cfg.vocab, (LM_BATCH, LM_SEQ)).astype(np.int32),
                "loss_mask": (rng.random((LM_BATCH, LM_SEQ)) < 0.9).astype(np.float32)}
    if family == "gnn":
        n, e = gnn_size(name)
        edges = rng.integers(0, n, (e, 2)).astype(np.int32)
        edges[-6:] = n  # trash padding
        b = {"feats": rng.standard_normal((n, cfg.d_feat)).astype(np.float32), "edges": edges}
        if cfg.task == "graph_class":
            b["graph_ids"] = np.sort(rng.integers(0, GNN_GRAPHS, n)).astype(np.int32)
            b["labels"] = rng.integers(0, cfg.n_out, GNN_GRAPHS).astype(np.int32)
            b["mask"] = np.array([1, 1, 0, 1], np.float32)[:GNN_GRAPHS]
            return b
        if cfg.task == "node_reg":
            b["labels"] = rng.standard_normal((n, cfg.n_out)).astype(np.float32)
        else:
            b["labels"] = rng.integers(0, cfg.n_out, n).astype(np.int32)
        b["mask"] = (rng.random(n) < 0.7).astype(np.float32)
        return b
    seq = rng.integers(0, cfg.n_items, (SAS_BATCH, cfg.seq_len)).astype(np.int32)
    seq[:, :3] = 0  # left padding
    return {"seq": seq, "pos": np.roll(seq, -1, 1),
            "neg": rng.integers(1, cfg.n_items, (SAS_BATCH, cfg.seq_len)).astype(np.int32)}


# ------------------------------------------------------------- the port side
def _port_ns():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.lm_archs import smoke_lm

    return smoke_lm, get_config, torch.float32


def port_case(family: str, cfg_name: str, name: str | None = None):
    """``(arch, shape, cfg, specs, loss)`` of a case in the port (``name``:
    the case's, for its size)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.gnn_archs import smoke_gnn
    from repro_torch.configs.sasrec import smoke_sasrec
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import sasrec as sas_lib
    from repro_torch.models import transformer as tfm

    if family == "lm":
        cfg = lm_config(cfg_name, _port_ns())
        arch = replace(get_config("granite-moe-1b-a400m" if cfg.moe else "yi-6b"), model=cfg)
        shape = ShapeSpec("train_4k", "train", seq_len=LM_SEQ, global_batch=LM_BATCH)
        return arch, shape, cfg, tfm.param_specs(cfg), tfm.lm_loss
    if family == "gnn":
        cfg = smoke_gnn(cfg_name.split("-")[0])
        if cfg_name.endswith("-graph"):
            cfg = replace(cfg, task="graph_class", n_out=2)
        arch = replace(get_config({"gin": "gin-tu", "gat": "gat-cora"}.get(cfg.arch, cfg.arch)),
                       model=cfg)
        n, e = gnn_size(name)
        shape = ShapeSpec("g", "graph_train", n_nodes=n, n_edges=e, d_feat=cfg.d_feat,
                          n_out=cfg.n_out, task=cfg.task, n_graphs=GNN_GRAPHS)
        return arch, shape, cfg, gnn_lib.param_specs(cfg), gnn_lib.gnn_loss
    cfg = smoke_sasrec()
    arch = replace(get_config("sasrec"), model=cfg)
    shape = ShapeSpec("train_batch", "train", global_batch=SAS_BATCH)
    return arch, shape, cfg, sas_lib.param_specs(cfg), sas_lib.sasrec_loss


def port_train(mesh, case, inputs: dict) -> dict:
    """Two steps of the case on ``mesh`` (``None``: one rank) from the
    inputs' parameters and batch: per-step loss and grad norm, and the
    parameters after, gathered whole."""
    import torch

    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    name, family, cfg_name, _, bits, compress, _ = case
    arch, shape, cfg, _, loss = port_case(family, cfg_name, name)
    params = {k: torch.as_tensor(v) for k, v in inputs["params"][name].items()}
    params = nest(params)
    batch = {k: torch.as_tensor(v) for k, v in inputs["batch"][name].items()}
    lr = LR[family]
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=lr, state_bits=bits), compress_grads=compress)
    state = opt.init_opt_state(params, tcfg.adamw)
    if mesh is None:
        fn = make_train_step(functools.partial(loss, cfg), tcfg)
    else:
        built = build_step(replace(arch, opt_state_bits=bits), shape, mesh)
        p_specs, o_specs, b_specs = built.in_specs
        fn = make_train_step(functools.partial(loss, cfg, place=built.place), tcfg,
                             mesh=built.place)
        params = shard_tree(params, p_specs, mesh)
        state = shard_tree(state, o_specs, mesh)
        batch = shard_tree(batch, b_specs, mesh)
    out = {}
    if family == "gnn" and mesh is not None:
        out["blocks"] = gnn_blocks(cfg, params, batch, built.place, shape.n_nodes)
    metrics = []
    for _ in range(STEPS):
        params, state, m = fn(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    if mesh is not None:
        params = gather_tree(params, p_specs, mesh)
    return {"metrics": metrics, "params": {k: v.numpy() for k, v in flatten(params).items()},
            **out}


def gnn_blocks(cfg, params, batch, place, n: int) -> dict:
    """A GNN forward on the rank's blocks: the rows of ``h`` entering and
    leaving each layer, of the output, the rank's block range and the loss."""
    import torch

    from repro_torch.models import gnn as gnn_lib
    from repro_torch.sharding.collectives import block_range

    rows = []
    saved = {k: getattr(gnn_lib, k) for k in ("_gin_layer", "_gat_layer", "_mpnn_layer")}

    def watch(fn):
        def layer(h, *a, **k):
            out = fn(h, *a, **k)
            rows.append((h.shape[0], (out[0] if isinstance(out, tuple) else out).shape[0]))
            return out
        return layer

    for k, fn in saved.items():
        setattr(gnn_lib, k, watch(fn))
    try:
        with torch.no_grad():
            out = gnn_lib.forward(cfg, params, batch, place)
            loss = gnn_lib.gnn_loss(cfg, params, batch, place)
    finally:
        for k, fn in saved.items():
            setattr(gnn_lib, k, fn)
    mesh = place.mesh
    axes = mesh.live_axes(mesh.axis_names)
    return {"layer_rows": rows, "out_rows": out.shape[0], "loss": float(loss),
            "range": block_range(n, mesh.extent(axes), mesh.index(axes))}


def blocks_autograd(mesh) -> dict:
    """``gather_blocks`` and ``reduce_blocks`` alone, with their gradients,
    on N = 9 rows (4 ranks: blocks of 3, the last empty; 2 ranks: 5 and
    4): each rank's block of a seeded X gathered and weighted by a
    rank's own W_r; partials P_r summed to the rank's block and weighted by
    V (whole, seeded)."""
    import torch

    from repro_torch.sharding.collectives import block_range, gather_blocks, reduce_blocks

    n, axes = 9, mesh.live_axes(mesh.axis_names)
    lo, hi = block_range(n, mesh.extent(axes), mesh.index(axes))
    g = torch.Generator().manual_seed(11)
    x = torch.randn((n, 3), generator=g)
    w = torch.randn((mesh.size, n, 3), generator=g)
    p = torch.randn((mesh.size, n, 3), generator=g)
    v = torch.randn((n, 3), generator=g)
    xb = x[lo:hi].clone().requires_grad_(True)
    whole = gather_blocks(xb, mesh, axes, n)
    (whole * w[mesh.rank]).sum().backward()
    pr = p[mesh.rank].clone().requires_grad_(True)
    own = reduce_blocks(pr, mesh, axes)
    (own * v[lo:hi]).sum().backward()
    return {"range": (lo, hi), "gathered": whole.detach().numpy(), "x": x.numpy(),
            "x_grad": xb.grad.numpy(), "w": w.numpy(), "own": own.detach().numpy(),
            "p": p.numpy(), "p_grad": pr.grad.numpy(), "v": v.numpy()}


def port_moe(mesh, case, inputs: dict) -> dict:
    import torch

    from repro_torch.models.layers import moe_mlp_shmap
    from repro_torch.sharding.collectives import all_gather_axes

    name, _, cap = case
    x, router, wg, wi, wo = (torch.as_tensor(a) for a in inputs["moe"])
    b, _, _, e, _, top_k = MOE_SHAPE
    bd, em = b // mesh.shape["data"], e // mesh.shape["model"]
    i, j = mesh.coords["data"], mesh.coords["model"]
    blk = slice(j * em, (j + 1) * em)
    out, aux = moe_mlp_shmap(x[i * bd:(i + 1) * bd], router, wg[blk], wi[blk], wo[blk],
                             top_k=top_k, capacity_local=cap, mesh=mesh,
                             expert_axis="model", token_axes=("data",))
    out = all_gather_axes(out, mesh, ("data",), 0)
    return {"out": out.numpy(), "aux": float(aux)}


def bgv_step(case, mesh):
    """The cut cell's built step on ``mesh`` (None: one rank) and its
    inputs, made from a seed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.launch.steps import build_step

    name, kind, rep, n, e, cols = case
    arch = get_config("biggraphvis")
    arch = replace(arch, model=replace(arch.model, layout_repulsion=rep, layout_grid_size=8,
                                       layout_grid_window=4))
    built = build_step(arch, ShapeSpec(name, kind, n_nodes=n, n_edges=e, n_out=cols), mesh)
    g = torch.Generator().manual_seed(7)
    edges = torch.randint(0, n, (e, 2), generator=g, dtype=torch.int32)
    edges[-e // 8:] = n  # trash padding
    if kind == "bgv_detect":
        com = torch.arange(n + 1, dtype=torch.int32)
        deg = torch.randint(0, 6, (n + 1,), generator=g, dtype=torch.int32)
        deg[n] = 0
        return built, (com, deg, edges)
    pos = fa2.init_positions(n, torch.Generator().manual_seed(3), device="cpu")
    args = (pos, 0.1 * torch.randn((n, 2), generator=g), 1.0 + torch.rand(n, generator=g) * 4,
            torch.rand(n, generator=g), edges, torch.rand(e, generator=g))
    if rep == "grid":
        args = args + tuple(grid_ops.bin_and_sort(pos, 8))
    return built, args


def port_bgv(mesh, case) -> dict:
    from repro_torch.sharding.params import gather_tree, shard_tree

    built, args = bgv_step(case, mesh)
    specs = built.in_specs
    local = [shard_tree(a, s, mesh) for a, s in zip(args, specs)]
    outs = built.fn(*local)
    if case[1] == "bgv_layout":  # the outputs are node blocks, as the inputs
        outs = [gather_tree(o, specs[0], mesh) for o in outs]
    return {f"out{i}": o.numpy() for i, o in enumerate(outs)}


def round_trip(mesh, inputs: dict) -> dict:
    """shard_tree then gather_tree of the dense LM's parameters and state on
    a mesh of every axis, and the rank's blocks."""
    import torch

    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.train import optimizer as opt

    name = "dense-8bit-compress-2x2" if mesh.size == 4 else "dense-8bit-1x2"
    arch, shape, cfg, _, _ = port_case("lm", "dense")
    params = nest({k: torch.as_tensor(v) for k, v in inputs["params"][name].items()})
    built = build_step(replace(arch, opt_state_bits=8), shape, mesh)
    state = opt.init_opt_state(params, opt.AdamWConfig(state_bits=8))
    p_specs, o_specs, _ = built.in_specs
    lp = shard_tree(params, p_specs, mesh)
    back = gather_tree(lp, p_specs, mesh)
    same = all(torch.equal(a, b) for a, b in zip(flatten(params).values(), flatten(back).values()))
    ls = shard_tree(state, o_specs, mesh)
    back_s = gather_tree(ls, o_specs, mesh)
    same_s = all(torch.equal(a, b) for a, b in zip(flatten(state).values(),
                                                   flatten(back_s).values()))
    return {"same_params": same, "same_state": same_s,
            "blocks": {k: v.numpy() for k, v in flatten(lp).items()},
            "specs": {k: tuple(v) for k, v in flatten(p_specs).items()}}


def run_all(_stream_mesh, inputs_path: str, out_dir: str) -> None:
    """Every case of this world size, on this rank."""
    import torch

    import os

    from repro_torch.launch.mesh import make_model_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    world = _stream_mesh.size
    res = {"train": {}, "moe": {}, "bgv": {}}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_model_mesh(shape, ("data", "model"), device="cpu")
        return meshes[shape]

    for case in CASES:
        if world_of(case[3]) == world:
            res["train"][case[0]] = port_train(mesh_of(case[3]), case, inputs)
    for case in MOE_CASES:
        if world_of(case[1]) == world:
            res["moe"][case[0]] = port_moe(mesh_of(case[1]), case, inputs)
    for shape in ((1, world), (world // 2, 2)) if world == 4 else ((1, world),):
        for case in BGV_CASES:
            res["bgv"][(case[0], shape)] = port_bgv(mesh_of(shape), case)
    res["blocks_autograd"] = blocks_autograd(mesh_of((1, world)))
    res["round_trip"] = round_trip(mesh_of((1, 2) if world == 2 else (2, 2)), inputs)
    res["coords"] = mesh_of((1, 2) if world == 2 else (2, 2)).coords
    with open(os.path.join(out_dir, f"rank{_stream_mesh.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
