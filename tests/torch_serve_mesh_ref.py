"""The reference's side of ``tests/test_torch_serve_mesh.py``, in a process
of its own with four host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_serve_mesh_ref.py INPUTS.pkl OUT.pkl [--blocks] CASE ...

For every case named it builds the reference's sharded step with
``launch.steps.build_step`` on ``jax.make_mesh(shape, ("data", "model"))``
with Auto axes (Explicit axes hit fault R3), runs it under its
``in_shardings`` and ``out_shardings`` from the inputs: train steps
(microbatched where the case says, the sequence split over "model" by
the reference's own rule), prefill, decode (a scalar ``cur_len``: the
reference writes every slot there, fault R5), SASRec serve and retrieval;
with ``--blocks`` it also records the blocks that
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

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_model_mesh_ref as MR  # noqa: E402
import torch_model_mesh_worker as MW  # noqa: E402
import torch_serve_mesh_worker as W  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.configs.lm_archs import smoke_lm  # noqa: E402
from repro.configs.sasrec import smoke_sasrec  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.train_loop import TrainConfig  # noqa: E402


def ref_arch(cfg_name):
    cfg = W.lm_config(cfg_name, (smoke_lm, get_config, jnp.float32))
    return replace(get_config(W.arch_name(cfg_name)), model=cfg)


def _params(inputs, name):
    return MW.nest({k: jnp.asarray(v) for k, v in inputs["params"][name].items()})


def ref_train(case, inputs):
    name, cfg_name, shape, (rows, seq), mb, _ = case
    saved = jsteps.opt, jsteps.TrainConfig
    jsteps.opt = types.SimpleNamespace(**{**vars(jopt), "AdamWConfig": functools.partial(
        jopt.AdamWConfig, lr=W.LR)})
    jsteps.TrainConfig = TrainConfig
    mesh = MR.make_mesh(shape)
    try:
        built = jsteps.build_step(replace(ref_arch(cfg_name), microbatch_train=mb),
                                  ShapeSpec("train_4k", "train", seq_len=seq, global_batch=rows),
                                  mesh)
    finally:
        jsteps.opt, jsteps.TrainConfig = saved
    params = _params(inputs, name)
    state = jopt.init_opt_state(params, jopt.AdamWConfig(lr=W.LR))
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"][name].items()}
    with mesh:
        step = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings)
        metrics = []
        for _ in range(W.STEPS):
            params, state, m = step(params, state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "params": MW.flatten(jax.tree_util.tree_map(np.asarray, params))}


def ref_prefill(case, inputs):
    name, cfg_name, shape, (rows, seq) = case
    mesh = MR.make_mesh(shape)
    built = jsteps.build_step(ref_arch(cfg_name),
                              ShapeSpec("prefill_32k", "prefill", seq_len=seq, global_batch=rows),
                              mesh)
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"][name].items() if k == "tokens"}
    with mesh:
        fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        return {"logits": np.asarray(fn(_params(inputs, name), batch))}


def ref_decode(case, inputs):
    name, cfg_name, shape = case[:3]
    mesh = MR.make_mesh(shape)
    built = jsteps.build_step(ref_arch(cfg_name),
                              ShapeSpec("decode_32k", "decode", seq_len=W.DECODE_SMAX,
                                        global_batch=W.DECODE_ROWS), mesh)
    d = inputs["decode"][name]
    cache = {k: jnp.asarray(d[k]) for k in ("k", "v")}
    params = _params(inputs, name)
    logits, caches = [], []
    with mesh:
        fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        for t in range(W.DECODE_STEPS):
            batch = {"tokens": jnp.asarray(d["tokens"][t]),
                     "cur_len": jnp.int32(int(d["cur_len"]) + t)}
            out, cache = fn(params, cache, batch)
            logits.append(np.asarray(out))
            caches.append({k: np.asarray(v) for k, v in cache.items()})
    return {"logits": logits, "caches": caches}


def ref_sas(case, inputs):
    name, kind, shape = case
    mesh = MR.make_mesh(shape)
    spec = (ShapeSpec("serve_p99", "serve", global_batch=W.SAS_ROWS) if kind == "serve" else
            ShapeSpec("retrieval_cand", "retrieval", global_batch=1,
                      n_candidates=W.SAS_CANDIDATES))
    built = jsteps.build_step(replace(get_config("sasrec"), model=smoke_sasrec()), spec, mesh)
    s = inputs["sas"][name]
    batch = ({"seq": jnp.asarray(s["seq"])} if kind == "serve" else
             {"seq": jnp.asarray(s["seq"][:1]), "candidates": jnp.asarray(s["candidates"])})
    with mesh:
        fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        return {"scores": np.asarray(fn(_params(inputs, name), batch))}


def main(inputs_path, out_path, *names):
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    res = {"train": {c[0]: ref_train(c, inputs) for c in W.TRAIN_CASES if c[0] in names},
           "prefill": {c[0]: ref_prefill(c, inputs) for c in W.PREFILL_CASES if c[0] in names},
           "decode": {c[0]: ref_decode(c, inputs) for c in W.DECODE_CASES if c[0] in names},
           "sas": {c[0]: ref_sas(c, inputs) for c in W.SAS_CASES if c[0] in names}}
    if "--blocks" in names:
        res["blocks"] = MR.ref_blocks(inputs)
    with open(out_path, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
