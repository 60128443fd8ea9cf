"""The port's side of ``tests/test_torch_dryrun.py``: the cases, and runs
that need a process group of their own (a fake world, or gloo ranks).

    python tests/torch_dryrun_worker.py OUT.json

traces, each as rank 0 of a fake world (``torch.testing``'s fake process
group), the chain of ``CHAIN`` over four ranks, the dense LM's train
step and prefill (``LM_SHAPE``) on the (2, 2) mesh, the ``GLOO_CELL``
on (1, 2), the ``GNN_CELLS``' train steps on one rank and on
``GNN_MESH`` and a grid-form layout step on ``GNN_MESH``, counting with ``op_analysis.OpCounter``; it writes their numbers
to ``OUT.json``. ``gloo_rank`` is the other side of the last: the same
step on a real 2-rank gloo group, its collectives counted by wrapping
``torch.distributed.all_reduce`` and ``all_gather``. This module imports
only the standard library at the top (spawned ranks import it), and never
``jax`` or the reference package.
"""
from __future__ import annotations

import json
import sys

# (m, k), (k, n), (n, o): a rank's rows of the left operand, and the two
# replicated right operands of the chain.
CHAIN = ((8, 16), (16, 32), (32, 8))
LM_MESH, LM_SHAPE = (2, 2), (4, 16)  # (rows, sequence)
GLOO_MESH = (1, 2)
# The GNN train steps held against the reference's per-device dot FLOPs:
# (arch, cell), on one rank and on GNN_MESH.
GNN_CELLS = (("gin-tu", "full_graph_sm"), ("graphcast", "full_graph_sm"))
GNN_MESH = (2, 2)


def _lm_built(kind: str, mesh, shape=LM_SHAPE):
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.lm_archs import smoke_lm
    from repro_torch.launch.steps import build_step

    rows, seq = shape
    arch = replace(get_config("yi-6b"), model=smoke_lm())
    name = "train_4k" if kind == "train" else "prefill_32k"
    return build_step(arch, ShapeSpec(name, kind, seq_len=seq, global_batch=rows), mesh)


def _fake_world(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _stats(stats) -> dict:
    return {"dot_flops": stats.dot_flops, "dot_traffic_bytes": stats.dot_traffic_bytes,
            "collective_counts": stats.collective_counts,
            "collective_calls": stats.collective_calls, "n_dots": stats.n_dots}


def chain() -> dict:
    """``CHAIN`` on a fake world of four ranks."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpCounter

    (m, k), (_, n), (_, o) = CHAIN
    _fake_world(4)
    try:
        with FakeTensorMode():
            a, w1, w2 = torch.empty(m, k), torch.empty(k, n), torch.empty(n, o)
            with OpCounter() as c:
                h = a @ w1
                dist.all_reduce(h)
                parts = [torch.empty_like(h) for _ in range(4)]
                dist.all_gather(parts, h)
                torch.cat(parts) @ w2
    finally:
        dist.destroy_process_group()
    return _stats(c.stats)


def traced(kind: str, mesh_shape, world: int, shape=LM_SHAPE) -> dict:
    """The dense LM's ``kind`` step as rank 0 of a fake world."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_model_mesh

    _fake_world(world)
    try:
        mesh = make_model_mesh(mesh_shape, ("data", "model"), device="cpu")
        stats, _ = dryrun.trace_step(_lm_built(kind, mesh, shape), mesh, mesh.device)
    finally:
        dist.destroy_process_group()
    return _stats(stats)


def traced_gnn(arch_name: str, cell: str, mesh_shape) -> dict:
    """A GNN cell's train step as rank 0 of a fake world of the mesh's
    size (on one rank, no process group)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_model_mesh
    from repro_torch.launch.steps import build_step

    world = mesh_shape[0] * mesh_shape[1]
    arch = get_config(arch_name)
    if world == 1:
        mesh = make_host_mesh(device="cpu")
        stats, _ = dryrun.trace_step(build_step(arch, arch.shapes[cell], mesh), mesh, mesh.device)
        return _stats(stats)
    _fake_world(world)
    try:
        mesh = make_model_mesh(mesh_shape, ("data", "model"), device="cpu")
        stats, _ = dryrun.trace_step(build_step(arch, arch.shapes[cell], mesh), mesh, mesh.device)
    finally:
        dist.destroy_process_group()
    return _stats(stats)


def grid_layout(mesh_shape) -> dict:
    """The grid form of a ``layout_berkstan``-shaped step as rank 0 of a
    fake world of the mesh's size, every plain kernel version refused:
    its kernel rules' counts."""
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.launch.steps import build_step

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} traced in place of a kernel")
        return f

    plain = {grid_ops: ("far_field_ref", "near_field_ref", "near_field_rows_ref"),
             rep_ops: ("repulsion_ref", "repulsion_chunked", "repulsion_chunked_rows"),
             seg_ops: ("segment_offsets_ref", "segment_sum_ref", "segment_sum_layout_ref",
                       "attraction_sum_ref")}
    saved = {(m, k): getattr(m, k) for m, names in plain.items() for k in names}
    for m, k in saved:
        setattr(m, k, refuse(k))
    arch = get_config("biggraphvis")
    arch = replace(arch, model=replace(arch.model, layout_repulsion="grid"))
    _fake_world(mesh_shape[0] * mesh_shape[1])
    try:
        mesh = make_model_mesh(mesh_shape, ("data", "model"), device="cpu")
        built = build_step(arch, arch.shapes["layout_berkstan"], mesh)
        stats, _ = dryrun.trace_step(built, mesh, mesh.device)
    finally:
        dist.destroy_process_group()
        for (m, k), fn in saved.items():
            setattr(m, k, fn)
    return stats.kernels


def _ring(kind: str, nbytes: int, k: int) -> float:
    if kind == "all-reduce":
        return nbytes * 2.0 * (k - 1) / k
    return nbytes * (k - 1) / k


def gloo_rank(_stream_mesh, out: str) -> None:
    """``GLOO_MESH``'s train step on real tensors under gloo, every
    ``all_reduce`` and ``all_gather`` the step issues counted (calls and
    payload bytes with the reference's ring factors); rank 0 writes them."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models.param import tree_map
    from repro_torch.sharding import collectives
    from repro_torch.sharding.params import shard_tree

    mesh = make_model_mesh(GLOO_MESH, ("data", "model"), device="cpu")
    built = _lm_built("train", mesh)
    calls, payload = {}, {}
    real = dist.all_reduce, dist.all_gather

    def note(kind, nbytes, group):
        k = dist.get_world_size(group)
        calls[kind] = calls.get(kind, 0) + 1
        payload[kind] = payload.get(kind, 0.0) + _ring(kind, nbytes, k)

    def all_reduce(t, *a, group=None, **kw):
        note("all-reduce", t.numel() * t.element_size(), group)
        return real[0](t, *a, group=group, **kw)

    def all_gather(parts, t, *a, group=None, **kw):
        note("all-gather", sum(p.numel() * p.element_size() for p in parts), group)
        return real[1](parts, t, *a, group=group, **kw)

    gen = torch.Generator().manual_seed(0)

    def full(x):
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, generator=gen, dtype=x.dtype) * 0.02
        return torch.randint(1, 90, x.shape, generator=gen, dtype=x.dtype)

    args = [shard_tree(tree_map(full, a), spec, mesh)
            for a, spec in zip(built.abstract_args, built.in_specs)]
    collectives.dist.all_reduce, collectives.dist.all_gather = all_reduce, all_gather
    try:
        built.fn(*args)
    finally:
        collectives.dist.all_reduce, collectives.dist.all_gather = real
    if mesh.rank == 0:
        with open(out, "w") as f:
            json.dump({"collective_calls": calls, "collective_counts": payload}, f)


def main() -> None:
    res = {"chain": chain(), "train": traced("train", LM_MESH, 4),
           "prefill": traced("prefill", LM_MESH, 4),
           "gloo_cell": traced("train", GLOO_MESH, 2),
           "gnn": {f"{a} {c} {m}": traced_gnn(a, c, m)
                   for a, c in GNN_CELLS for m in ((1, 1), GNN_MESH)},
           "grid_layout": grid_layout(GNN_MESH)}
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
