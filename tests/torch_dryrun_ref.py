"""The reference's side of ``tests/test_torch_dryrun.py``, in a process of
its own with four host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_dryrun_ref.py OUT.json

It lowers and compiles, as the reference's dry run does, and reads with
its ``launch.hlo_analysis.analyze_hlo``: (a) a chain of two products with an
all-reduce and an all-gather between them, under ``shard_map`` over four
devices; (b) a dense LM train step and (c) its prefill, at 2 layers of
``smoke_lm``'s width, on a (2, 2) mesh with Auto axes (Explicit axes hit
fault R3); (d) the GNN cells' train steps (``W.GNN_CELLS``) on one device
and on that mesh. It writes each analysis's numbers to ``OUT.json``.
"""
import json
import os
import sys
from dataclasses import replace
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dryrun_worker as W  # noqa: E402
import torch_model_mesh_ref as MR  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeSpec  # noqa: E402
from repro.configs.lm_archs import smoke_lm  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402


def _numbers(compiled) -> dict:
    h = analyze_hlo(compiled.as_text())
    return {"dot_flops": h.dot_flops, "dot_traffic_bytes": h.dot_traffic_bytes,
            "collective_counts": h.collective_counts, "n_dots": h.n_dots}


def chain() -> dict:
    """W.CHAIN's program: per device ``a @ w1`` summed over the four
    devices, gathered along rows, ``@ w2``."""
    mesh = jax.make_mesh((4,), ("x",), axis_types=(jax.sharding.AxisType.Auto,))
    (m, k), (_, n), (_, o) = W.CHAIN

    def local(a, w1, w2):
        h = jax.lax.psum(a @ w1, "x")
        g = jax.lax.all_gather(h, "x", tiled=True)
        return g @ w2

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("x"), P(), P()),
                               out_specs=P(), check_vma=False))
    args = (jax.ShapeDtypeStruct((4 * m, k), jnp.float32),
            jax.ShapeDtypeStruct((k, n), jnp.float32), jax.ShapeDtypeStruct((n, o), jnp.float32))
    return _numbers(fn.lower(*args).compile())


def lm(kind: str) -> dict:
    """The dense LM's ``kind`` step (W.LM_SHAPE) on the (2, 2) mesh."""
    mesh = MR.make_mesh(W.LM_MESH)
    rows, seq = W.LM_SHAPE
    arch = replace(get_config("yi-6b"), model=smoke_lm())
    name = "train_4k" if kind == "train" else "prefill_32k"
    built = jsteps.build_step(arch, ShapeSpec(name, kind, seq_len=seq, global_batch=rows), mesh)
    with mesh:
        lowered = jax.jit(built.fn, in_shardings=built.in_shardings,
                          out_shardings=built.out_shardings).lower(*built.abstract_args)
    return _numbers(lowered.compile())


def gnn(arch_name: str, cell: str, shape) -> dict:
    """A GNN cell's train step (``launch.steps.build_gnn_step``: the node
    state constrained to every axis) on a mesh of ``shape``."""
    mesh = MR.make_mesh(shape)
    arch = get_config(arch_name)
    built = jsteps.build_step(arch, arch.shapes[cell], mesh)
    with mesh:
        lowered = jax.jit(built.fn, in_shardings=built.in_shardings,
                          out_shardings=built.out_shardings).lower(*built.abstract_args)
    return _numbers(lowered.compile())


def main() -> None:
    out = {"chain": chain(), "train": lm("train"), "prefill": lm("prefill"),
           "gnn": {f"{a} {c} {m}": gnn(a, c, m)
                   for a, c in W.GNN_CELLS for m in ((1, 1), W.GNN_MESH)}}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
