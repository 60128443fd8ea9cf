"""The reference's side of ``tests/test_torch_model_mesh.py``, in a process
of its own with four host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_model_mesh_ref.py INPUTS.pkl OUT.pkl [--moe] CASE ...

For every case named (with ``--moe``, the MoE cases and the blocks as
well) it builds the reference's
sharded step with ``launch.steps.build_step`` on ``jax.make_mesh(shape,
("data", "model"))`` with Auto axes (Explicit axes hit fault R3) and runs
it under its ``in_shardings`` from the inputs' parameters and batch
(AdamW's lr and ``compress_grads`` set as the case asks), runs
``moe_mlp_shmap`` on the MoE cases, and records the blocks that
``NamedSharding.devices_indices_map`` gives each device.
"""
import functools
import os
import pickle
import sys
import types
from dataclasses import replace
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_model_mesh_worker as W  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.configs.gnn_archs import smoke_gnn  # noqa: E402
from repro.configs.lm_archs import smoke_lm  # noqa: E402
from repro.configs.sasrec import smoke_sasrec  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_loop import TrainConfig  # noqa: E402


def make_mesh(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])


def ref_case(family, cfg_name):
    if family == "lm":
        cfg = W.lm_config(cfg_name, (smoke_lm, get_config, jnp.float32))
        arch = replace(get_config("granite-moe-1b-a400m" if cfg.moe else "yi-6b"), model=cfg)
        return arch, ShapeSpec("train_4k", "train", seq_len=W.LM_SEQ,
                               global_batch=W.LM_BATCH)
    if family == "gnn":
        cfg = smoke_gnn(cfg_name)
        arch = replace(get_config({"gin": "gin-tu", "gat": "gat-cora"}.get(cfg_name, cfg_name)),
                       model=cfg)
        return arch, ShapeSpec("g", "graph_train", n_nodes=W.GNN_NODES, n_edges=W.GNN_EDGES,
                               d_feat=cfg.d_feat, n_out=cfg.n_out, task=cfg.task)
    return (replace(get_config("sasrec"), model=smoke_sasrec()),
            ShapeSpec("train_batch", "train", global_batch=W.SAS_BATCH))


def ref_train(case, inputs):
    name, family, cfg_name, shape, bits, compress, _ = case
    arch, spec = ref_case(family, cfg_name)
    lr = W.LR[family]
    # build_step's AdamW and TrainConfig, with the case's lr and compression.
    saved = jsteps.opt, jsteps.TrainConfig
    jsteps.opt = types.SimpleNamespace(**{**vars(jopt), "AdamWConfig": functools.partial(
        jopt.AdamWConfig, lr=lr)})
    jsteps.TrainConfig = functools.partial(TrainConfig, compress_grads=compress)
    arch = replace(arch, opt_state_bits=bits)
    mesh = make_mesh(shape)
    try:
        built = jsteps.build_step(arch, spec, mesh)
    finally:
        jsteps.opt, jsteps.TrainConfig = saved
    params = W.nest({k: jnp.asarray(v) for k, v in inputs["params"][name].items()})
    state = jopt.init_opt_state(params, jopt.AdamWConfig(lr=lr, state_bits=bits))
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"][name].items()}
    with mesh:
        step = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings)
        metrics = []
        for _ in range(W.STEPS):
            params, state, m = step(params, state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    flat = W.flatten(jax.tree_util.tree_map(np.asarray, params))
    return {"metrics": metrics, "params": flat}


def ref_moe(case, inputs):
    name, shape, cap = case
    mesh = make_mesh(shape)
    x, router, wg, wi, wo = (jnp.asarray(a) for a in inputs["moe"])
    top_k = W.MOE_SHAPE[-1]
    fn = jax.jit(functools.partial(jlayers.moe_mlp_shmap, top_k=top_k, capacity_local=cap,
                                   mesh=mesh, expert_axis="model", token_axes=("data",)))
    with mesh:
        out, aux = fn(x, router, wg, wi, wo)
    return {"out": np.asarray(out), "aux": float(aux)}


def ref_blocks(inputs):
    """``devices_indices_map`` of every (shape, spec, mesh) asked for: the
    (start, stop) of each dim, by device linear index."""
    out = {}
    for key, (shape, spec, mesh_shape) in inputs["blocks"].items():
        mesh = make_mesh(mesh_shape)
        m = NamedSharding(mesh, jax.sharding.PartitionSpec(*spec)).devices_indices_map(shape)
        out[key] = [tuple((s.start or 0, s.stop if s.stop is not None else n)
                          for s, n in zip(m[dev], shape))
                    for dev in mesh.devices.flat]
    return out


def main(inputs_path, out_path, *names):
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    res = {"train": {c[0]: ref_train(c, inputs) for c in W.CASES if c[0] in names}}
    if "--moe" in names:
        res["moe"] = {c[0]: ref_moe(c, inputs) for c in W.MOE_CASES}
        res["blocks"] = ref_blocks(inputs)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
