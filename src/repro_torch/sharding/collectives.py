"""The collectives of the multi-device paths, on the tensor's own device.

Every cross-rank step of the port goes through this module:

* ``all_gather_rows`` — every rank's tensor concatenated along dim 0 in
  rank order (the reference's tiled ``all_gather``);
* ``all_reduce`` — elementwise sum, max or min over the ranks, in place;
* ``any_rank`` — one flag agreed by every rank (a max of 0/1), for the
  decisions that steer control flow (a SIGTERM, a quarantine verdict):
  ranks that disagreed on them would wait in different collectives;
* ``barrier``.

Over a set of named axes of a ``launch.mesh.ModelMesh`` (the group of the
ranks that differ only along them; axes of extent 1 and axes absent from
the mesh drop out, and an empty set is the identity):

* ``all_reduce_axes`` — sum or max;
* ``all_gather_axes`` — every rank's block concatenated along a dim, in
  the block order of a spec entry (row-major over the axes as listed);
* the autograd Functions of the model paths: ``gather_param`` (all-gather
  forward; backward, the gradient summed over the axes the batch was split
  on and this rank's block kept: ZeRO-3), ``copy_to`` (identity forward,
  all-reduce backward: Megatron's f) and ``reduce_from`` (all-reduce
  forward, identity backward: Megatron's g), and ``sum_shards``
  (all-reduce forward and backward: a sum of per-rank terms of a loss that
  is itself summed over those ranks).

A reduce-scatter is an all-reduce and a slice.

Only ``dist.all_gather`` (a list of outputs) and ``dist.all_reduce`` are
used: both exist with the same meaning in every torch this repository runs
on, and gloo takes CUDA tensors in both (SUM, MAX and MIN; checked on the
card by ``tools/collective_probe.py``), staging them through the host. With
a mesh of one every call returns its input.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """[k, ...] on every rank → [size·k, ...], rank 0's rows first."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def all_reduce(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the ranks in place (``op``: sum, max or min) and
    return it. Integer sums, maxima and minima do not depend on the order
    the ranks are combined in; a float sum is exact while its terms are
    integer-valued below 2^24."""
    if mesh.size > 1:
        dist.all_reduce(x, op=_OPS[op], group=mesh.group)
    return x


def any_rank(flag: bool, mesh) -> bool:
    """True on every rank if ``flag`` is true on any."""
    if mesh.size == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    return bool(all_reduce(t, mesh, "max").item())


def barrier(mesh) -> None:
    """Wait until every rank gets here."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


# ------------------------------------------------------- named-axis collectives


def _group(mesh, axes):
    live = mesh.live_axes(axes)
    return live, (mesh.groups[live] if live else None)


def all_reduce_axes(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over ``axes`` in place (sum or max) and return it."""
    live, group = _group(mesh, axes)
    if live:
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_gather_axes(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every block along ``axes`` concatenated along ``dim``: block k is the
    rank whose ``mesh.index(axes)`` is k (``axes`` a spec entry, row-major
    in its own order)."""
    live, group = _group(mesh, axes)
    if not live:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.extent(live))]
    dist.all_gather(parts, x, group=group)
    # The group lists its ranks in ascending global rank, which is
    # row-major over ``live`` in mesh order; put them in the entry's order.
    from repro_torch.launch.mesh import mesh_coords

    names = tuple(mesh.shape)
    sizes = tuple(mesh.shape.values())
    members = sorted(r for r in range(mesh.size)
                     if all(mesh_coords(r, names, sizes)[a] == mesh.coords[a]
                            for a in names if a not in live))
    order = [0] * len(parts)
    entry = tuple(a for a in ((axes,) if isinstance(axes, str) else axes) if a in live)
    for slot, r in enumerate(members):
        c = mesh_coords(r, names, sizes)
        k = 0
        for a in entry:
            k = k * mesh.shape[a] + c[a]
        order[k] = slot
    return torch.cat([parts[i] for i in order], dim=dim)


def _block(g: torch.Tensor, mesh, gathered: dict) -> torch.Tensor:
    """This rank's block of the full tensor ``g`` along every gathered dim."""
    for dim, axes in gathered.items():
        k = mesh.extent(axes)
        if k > 1:
            size = g.shape[dim] // k
            g = g.narrow(dim, mesh.index(axes) * size, size)
    return g.contiguous()


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, gathered, reduce_axes):
        ctx.mesh, ctx.gathered, ctx.reduce_axes = mesh, gathered, reduce_axes
        for dim, axes in gathered.items():
            x = all_gather_axes(x, mesh, axes, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.mesh.live_axes(ctx.reduce_axes):
            g = all_reduce_axes(g.clone(), ctx.mesh, ctx.reduce_axes, "sum")
        return _block(g, ctx.mesh, ctx.gathered), None, None, None


def gather_param(x: torch.Tensor, mesh, gathered: dict, reduce_axes=()) -> torch.Tensor:
    """A parameter block made whole along ``gathered`` ({dim: spec entry})
    for use. Backward: the full gradient summed over ``reduce_axes`` (the
    axes of ``gathered`` that the batch was split on: there each rank's
    gradient is its shard's part; along the others every rank computed the
    whole gradient) and this rank's block kept."""
    if not any(mesh.live_axes(a) for a in gathered.values()):
        return x
    return _GatherParam.apply(x, mesh, dict(gathered), tuple(reduce_axes))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g.contiguous().clone(), ctx.mesh, ctx.axes, "sum"), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_axes(x.contiguous().clone(), mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_axes(x.contiguous().clone(), mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g.contiguous().clone(), ctx.mesh, ctx.axes, "sum"), None, None


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Megatron's f: ``x`` (the same on every rank of ``axes``) entering a
    computation split over them; its gradient summed over them."""
    if mesh is None or not mesh.live_axes(axes):
        return x
    return _CopyTo.apply(x, mesh, tuple(mesh.live_axes(axes)))


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Megatron's g: the partial results of ``axes`` summed; the gradient of
    the (replicated) sum passes through unchanged."""
    if mesh is None or not mesh.live_axes(axes):
        return x
    return _ReduceFrom.apply(x, mesh, tuple(mesh.live_axes(axes)))


def sum_shards(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Per-rank terms summed over ``axes`` (the batch axes), where each rank
    adds its own share of the loss: the gradient is summed as well."""
    if mesh is None or not mesh.live_axes(axes):
        return x
    return _SumShards.apply(x, mesh, tuple(mesh.live_axes(axes)))
