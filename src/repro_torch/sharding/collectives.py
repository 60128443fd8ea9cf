"""The collectives of the multi-device paths, on the tensor's own device.

Every cross-rank step of the port goes through this module:

* ``all_gather_rows`` — every rank's tensor concatenated along dim 0 in
  rank order (the reference's tiled ``all_gather``);
* ``all_reduce`` — elementwise sum, max or min over the ranks, in place;
* ``any_rank`` — one flag agreed by every rank (a max of 0/1), for the
  decisions that steer control flow (a SIGTERM, a quarantine verdict):
  ranks that disagreed on them would wait in different collectives;
* ``barrier``.

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
