"""The cases of ``tests/test_torch_serve_mesh.py`` and the rank side of them.

Both packages build their configs from the plain descriptions here, and
``tests/torch_serve_mesh_ref.py`` runs the reference's side in a process of
its own. Ranks are fresh processes that import this module, so it imports
only ``numpy`` and the model mesh helpers (themselves numpy only), and
``torch`` and ``repro_torch`` inside the functions that use them (never
``jax`` or the reference package). ``run_all`` runs every case of a world
size on the rank's meshes and writes the rank's results to
``{out}/rank{r}.pkl``.
"""
from __future__ import annotations

import functools
import math
import os
import pickle
from dataclasses import replace

import numpy as np

import torch_model_mesh_worker as MW

STEPS = MW.STEPS
LR = MW.LR["lm"]
# A train case: (name, config, mesh shape, (rows, sequence), microbatches,
# held against): "ref" the reference's sharded step, "one" the port's
# one-rank step, "nosp" the same step with ``Placement.seq_axis`` None
# (bitwise). F3's cases microbatch on a mesh that splits the batch; G1's
# split 8 rows into 4 microbatches of 2, which (4, 1)'s 4 batch shards take
# unevenly (two ranks a row, two none; (2, 2)'s 2 shards a row each); the SP
# cases split the sequence over "model"; "sp-off" has a sequence that does
# not divide over it.
TRAIN_CASES = [
    ("f3-dense-2x1", "dense", (2, 1), (4, 16), 2, ("ref", "one")),
    ("f3-dense-2x2", "dense", (2, 2), (4, 16), 2, ("ref", "one")),
    ("f3-granite-drop-2x2", "granite-drop", (2, 2), (4, 32), 2, ("ref",)),
    ("g1-dense-4x1", "dense", (4, 1), (8, 16), 4, ("ref", "one")),
    ("g1-dense-2x2", "dense", (2, 2), (8, 16), 4, ("ref", "one")),
    ("g1-granite-2x2", "granite", (2, 2), (8, 16), 4, ("ref",)),
    ("sp-dense-1x2", "dense", (1, 2), (4, 16), 0, ("ref", "nosp")),
    ("sp-dense-2x2", "dense", (2, 2), (4, 16), 0, ("ref", "nosp")),
    ("sp-granite-1x2", "granite", (1, 2), (4, 16), 0, ("ref", "nosp")),
    ("sp-off-1x2", "dense", (1, 2), (4, 15), 0, ("ref",)),
]
# (name, config, mesh shape, (rows, sequence))
PREFILL_CASES = [
    ("prefill-dense-1x2", "dense", (1, 2), (4, 16)),
    ("prefill-dense-2x2", "dense", (2, 2), (4, 16)),
    ("prefill-granite-1x2", "granite", (1, 2), (4, 16)),
]
DECODE_ROWS, DECODE_SMAX, DECODE_STEPS = 4, 32, 3
# A decode case: (name, config, mesh shape, cur_len (an int: every slot at
# one length, against the reference's sharded decode; a list: each slot's
# own, against the port's one-rank decode), active or None). The slots of
# 15 cross the rank boundary at 16 on the second step; on the sliding
# config (window 8, layer 0 local) the slot at 28 finds rank 0's positions
# [0, 16) all masked.
DECODE_CASES = [
    ("decode-ref-1x2", "dense", (1, 2), 15, None),
    ("decode-ref-2x2", "dense", (2, 2), 15, None),
    ("decode-slots-1x2", "dense", (1, 2), [3, 15, 27, 9], [1, 1, 1, 0]),
    ("decode-slots-2x2", "dense", (2, 2), [3, 15, 27, 9], [1, 1, 0, 1]),
    ("decode-sliding-1x2", "sliding", (1, 2), [28, 15, 5, 22], [1, 1, 1, 0]),
    ("decode-granite-2x2", "granite", (2, 2), [4, 15, 20, 9], None),
]
SAS_ROWS, SAS_CANDIDATES = 8, 64
# (name, kind, mesh shape)
SAS_CASES = [
    ("serve-1x2", "serve", (1, 2)),
    ("serve-2x1", "serve", (2, 1)),
    ("serve-2x2", "serve", (2, 2)),
    ("retrieval-1x2", "retrieval", (1, 2)),
    ("retrieval-2x2", "retrieval", (2, 2)),
]
# The reference's cases in groups of about equal compile time, one process
# each; the first also computes the blocks.
REF_GROUPS = [
    ["f3-dense-2x1", "f3-dense-2x2", "sp-off-1x2", "prefill-dense-1x2", "serve-1x2",
     "serve-2x1", "retrieval-1x2", "g1-dense-4x1"],
    ["f3-granite-drop-2x2", "sp-granite-1x2", "prefill-granite-1x2", "decode-ref-1x2",
     "serve-2x2", "g1-granite-2x2"],
    ["sp-dense-1x2", "sp-dense-2x2", "prefill-dense-2x2", "decode-ref-2x2", "retrieval-2x2",
     "g1-dense-2x2"],
]
# devices_indices_map cases: the cache's spec (``P(None, bdim, "model", None,
# None)``, bdim "data" where it splits the rows) and the candidates' (every
# axis) on three meshes.
BLOCK_CASES = {}
for _s in ((1, 2), (2, 1), (2, 2)):
    _bdim = "data" if _s[0] > 1 else None
    BLOCK_CASES[f"cache-{_s[0]}x{_s[1]}"] = ((2, DECODE_ROWS, DECODE_SMAX, 2, 16),
                                              (None, _bdim, "model", None, None), _s)
    BLOCK_CASES[f"candidates-{_s[0]}x{_s[1]}"] = ((SAS_CANDIDATES,), (("data", "model"),), _s)


def lm_config(name: str, ns):
    """The LM config of ``name`` from a configs namespace (``smoke_lm``,
    ``get_config``, float32) of its package. "granite-drop": capacity
    factor 0.25, so a rank's 32 × 2 (token, choice) pairs of a
    microbatch meet 4 experts × 8 slots and at least half are dropped."""
    smoke_lm = ns[0]
    if name == "dense":
        return smoke_lm()
    if name == "sliding":
        return smoke_lm(sliding=True)
    cfg = MW.lm_config("granite", ns)
    if name == "granite-drop":
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=0.25))
    return cfg


def arch_name(cfg_name: str) -> str:
    return {"sliding": "gemma3-4b", "granite": "granite-moe-1b-a400m",
            "granite-drop": "granite-moe-1b-a400m"}.get(cfg_name, "yi-6b")


def lm_batch(cfg, rows: int, seq: int, seed: int) -> dict:
    """Tokens and a ragged loss mask (60 % of positions)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab, (rows, seq)).astype(np.int32),
            "loss_mask": (rng.random((rows, seq)) < 0.6).astype(np.float32)}


def decode_inputs(cfg, case, seed: int) -> dict:
    """A seeded cache (every position filled, live or not), the tokens of
    every step and the slots' lengths and activity."""
    _, _, _, cur, active = case
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, DECODE_ROWS, DECODE_SMAX, cfg.n_kv_heads, cfg.head_dim)
    out = {"k": rng.standard_normal(shape).astype(np.float32),
           "v": rng.standard_normal(shape).astype(np.float32),
           "tokens": rng.integers(1, cfg.vocab, (DECODE_STEPS, DECODE_ROWS, 1)).astype(np.int32)}
    if isinstance(cur, int):
        out["cur_len"] = np.int32(cur)
    else:
        out["cur_len"] = np.asarray(cur, np.int32)
        out["active"] = np.asarray(active if active is not None else [1] * DECODE_ROWS, bool)
    return out


def sas_inputs(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.n_items, (SAS_ROWS, cfg.seq_len)).astype(np.int32)
    seq[:, :3] = 0
    return {"seq": seq, "candidates": rng.integers(0, cfg.n_items, SAS_CANDIDATES).astype(np.int32)}


def world_of(shape) -> int:
    return math.prod(shape)


# ------------------------------------------------------------- the port side
def _ns():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.lm_archs import smoke_lm

    return smoke_lm, get_config, torch.float32


def port_arch(cfg_name: str):
    from repro_torch.configs import get_config

    cfg = lm_config(cfg_name, _ns())
    return replace(get_config(arch_name(cfg_name)), model=cfg), cfg


def _tensors(d: dict) -> dict:
    import torch

    return {k: torch.as_tensor(v) for k, v in d.items()}


def port_train(mesh, case, inputs: dict, seq_axis="auto") -> dict:
    """STEPS steps of the case on ``mesh`` (None: one rank) from the inputs'
    parameters and batch; ``seq_axis`` "auto" keeps ``build_step``'s
    placement, None turns sequence parallelism off. Per-step loss and grad
    norm, the parameters after (gathered whole) and the placement's
    ``seq_axis``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    name, cfg_name, _, (rows, seq), mb, _ = case
    arch, cfg = port_arch(cfg_name)
    params = MW.nest(_tensors(inputs["params"][name]))
    batch = _tensors(inputs["batch"][name])
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=LR), microbatch=mb)
    state = opt.init_opt_state(params, tcfg.adamw)
    sp = None
    if mesh is None:
        fn = make_train_step(functools.partial(tfm.lm_loss, cfg), tcfg)
    else:
        built = build_step(replace(arch, microbatch_train=mb),
                           ShapeSpec("train_4k", "train", seq_len=seq, global_batch=rows), mesh)
        place = built.place if seq_axis == "auto" else replace(built.place, seq_axis=seq_axis)
        sp = place.seq_axis
        p_specs, o_specs, b_specs = built.in_specs
        fn = make_train_step(functools.partial(tfm.lm_loss, cfg, place=place), tcfg, mesh=place)
        params = shard_tree(params, p_specs, mesh)
        state = shard_tree(state, o_specs, mesh)
        batch = shard_tree(batch, b_specs, mesh)
    metrics = []
    for _ in range(STEPS):
        params, state, m = fn(params, state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    if mesh is not None:
        params = gather_tree(params, p_specs, mesh)
    return {"metrics": metrics, "seq_axis": sp,
            "params": {k: v.numpy() for k, v in MW.flatten(params).items()}}


def port_prefill(mesh, case, inputs: dict) -> dict:
    """The case's prefill on ``mesh`` (None: one rank): the logits, gathered
    whole, and whether the sequence was split."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.params import gather_tree, shard_tree

    name, cfg_name, _, (rows, seq) = case
    arch, cfg = port_arch(cfg_name)
    params = MW.nest(_tensors(inputs["params"][name]))
    batch = {"tokens": _tensors(inputs["batch"][name])["tokens"]}
    if mesh is None:
        return {"logits": tfm.make_prefill(cfg)(params, batch).numpy()}
    built = build_step(arch, ShapeSpec("prefill_32k", "prefill", seq_len=seq, global_batch=rows),
                       mesh)
    p_specs, b_specs = built.in_specs
    out = built.fn(shard_tree(params, p_specs, mesh), shard_tree(batch, b_specs, mesh))
    return {"logits": gather_tree(out, built.out_specs, mesh).numpy(), "sp": built.place.sp}


def port_decode(mesh, case, inputs: dict) -> dict:
    """DECODE_STEPS decode steps of the case on ``mesh`` (None: one rank)
    from the seeded cache, the slots' lengths advancing with their
    activity: every step's logits and the cache after each step, gathered
    whole."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.sharding.rules import P

    name, cfg_name = case[:2]
    arch, cfg = port_arch(cfg_name)
    params = MW.nest(_tensors(inputs["params"][name]))
    d = inputs["decode"][name]
    cache = {k: torch.as_tensor(d[k]).clone() for k in ("k", "v")}
    cur = torch.as_tensor(d["cur_len"])
    active = torch.as_tensor(d["active"]) if "active" in d else None
    if mesh is None:
        fn = tfm.make_decode_step(cfg)
    else:
        built = build_step(arch, ShapeSpec("decode_32k", "decode", seq_len=DECODE_SMAX,
                                           global_batch=DECODE_ROWS), mesh)
        fn = built.fn
        p_specs, c_specs, b_specs = built.in_specs
        params = shard_tree(params, p_specs, mesh)
        cache = shard_tree(cache, c_specs, mesh)
        rows = P(b_specs["tokens"][0])
    logits, caches = [], []
    for t in range(DECODE_STEPS):
        batch = {"tokens": torch.as_tensor(d["tokens"][t]), "cur_len": cur}
        if active is not None:
            batch["active"] = active
        if mesh is not None:
            specs = {"tokens": b_specs["tokens"], "cur_len": rows if cur.dim() else P(),
                     "active": rows}
            batch = shard_tree(batch, {k: specs[k] for k in batch}, mesh)
        out, cache = fn(params, cache, batch)
        if mesh is not None:
            out = gather_tree(out, built.out_specs[0], mesh)
            whole = gather_tree(cache, c_specs, mesh)
        else:
            whole = cache
        logits.append(out.numpy())
        caches.append({k: v.numpy().copy() for k, v in whole.items()})
        cur = cur + (active.to(cur.dtype) if active is not None else 1)
    return {"logits": logits, "caches": caches}


def port_sas(mesh, case, inputs: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.sasrec import smoke_sasrec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import sasrec as sas_lib
    from repro_torch.sharding.params import gather_tree, shard_tree

    name, kind, _ = case
    cfg = smoke_sasrec()
    params = MW.nest(_tensors(inputs["params"][name]))
    s = _tensors(inputs["sas"][name])
    batch = {"seq": s["seq"]} if kind == "serve" else {"seq": s["seq"][:1],
                                                         "candidates": s["candidates"]}
    if mesh is None:
        fn = (sas_lib.make_serve_step if kind == "serve" else sas_lib.make_retrieval_step)(cfg)
        return {"scores": fn(params, batch).numpy()}
    shape = (ShapeSpec("serve_p99", "serve", global_batch=SAS_ROWS) if kind == "serve" else
             ShapeSpec("retrieval_cand", "retrieval", global_batch=1,
                       n_candidates=SAS_CANDIDATES))
    built = build_step(replace(get_config("sasrec"), model=cfg), shape, mesh)
    p_specs, b_specs = built.in_specs
    out = built.fn(shard_tree(params, p_specs, mesh), shard_tree(batch, b_specs, mesh))
    return {"scores": gather_tree(out, built.out_specs, mesh).numpy()}


def run_all(_stream_mesh, inputs_path: str, out_dir: str) -> None:
    """Every case of this world size, on this rank (the decode cases twice:
    two runs must agree bitwise)."""
    import torch

    from repro_torch.launch.mesh import make_model_mesh

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    world = _stream_mesh.size
    res = {"train": {}, "nosp": {}, "prefill": {}, "decode": {}, "decode2": {}, "sas": {}}
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_model_mesh(shape, ("data", "model"), device="cpu")
        return meshes[shape]

    torch.manual_seed(0)
    for case in TRAIN_CASES:
        if world_of(case[2]) == world:
            res["train"][case[0]] = port_train(mesh_of(case[2]), case, inputs)
            if "nosp" in case[5]:
                res["nosp"][case[0]] = port_train(mesh_of(case[2]), case, inputs, seq_axis=None)
    for case in PREFILL_CASES:
        if world_of(case[2]) == world:
            res["prefill"][case[0]] = port_prefill(mesh_of(case[2]), case, inputs)
    for case in DECODE_CASES:
        if world_of(case[2]) == world:
            res["decode"][case[0]] = port_decode(mesh_of(case[2]), case, inputs)
            res["decode2"][case[0]] = port_decode(mesh_of(case[2]), case, inputs)
    for case in SAS_CASES:
        if world_of(case[2]) == world:
            res["sas"][case[0]] = port_sas(mesh_of(case[2]), case, inputs)
    res["coords"] = {s: m.coords for s, m in meshes.items()}
    with open(os.path.join(out_dir, f"rank{_stream_mesh.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
