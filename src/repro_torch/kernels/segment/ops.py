"""Public wrappers for the segment sum: kernel K7 (``csrc/segment_sum.cu``)
for CUDA tensors, the plain PyTorch versions (``ref.py``) for CPU tensors.
A tensor anywhere else raises.

Two families of entries, each counted under its own name:

* ``segment_sum``, a warp per segment with its bounds searched at every
  launch: the grid repulsion's cell statistics (4,096 long segments).
* The layout entries, for many short segments whose ids stay fixed
  across launches. ``segment_layout`` builds a ``SegmentLayout`` once for
  an id array (a stable sort by id, then the segment offsets through the
  ``segment_offsets`` entry); ``segment_sum_edges`` (per-edge terms summed
  into their rows: the GNN's message sums, FA2's two-scatter attraction),
  the backward of ``gather_rows`` (``segment_sum_gather_bwd``) and
  ``attraction_sum`` (FA2's sorted attraction, its terms formed in the
  kernel) sum through one, reading each row where it lies: no launch sorts
  or copies its data.

On the card every entry adds each segment in row order from +0, as the
CPU's ``index_add_`` does, so the sums are its bits and the same from run
to run, where ``index_add_`` on the card would add on float atomics.

``segment_sum_edges`` and ``gather_rows`` (the GNN's row gather) are
``torch.autograd.Function``s on both devices, each the other's transpose:
the sum's backward gathers the output gradient back onto the edges (the
transpose of the reference's segment sum, plain torch), and the gather's
backward sums the edge gradients into their rows through K7. Autograd's
own backward for ``x[idx]`` would add on float atomics; this one keeps a
training step on the card the same bits from run to run.

A fake tensor takes each entry's abstract rule (``build.route``): the
allocations of the card's call (output, and ``segment_sum``'s sorted copy)
with the launch left out, and its ``*_cost`` (operations, bytes). A rule
cannot read the offsets, so ``attraction_sum``'s counts every row as kept,
the most a launch adds.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment.ref import (
    attraction_sum_ref,
    segment_offsets_ref,
    segment_sum_layout_ref,
    segment_sum_ref,
)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_OFFSETS_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
_LAYOUT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_ATTRACTION_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p, ctypes.c_void_p]
# A group of a layout (a warp of the narrow kernels): a block of 32
# consecutive segments, or, where the block's rows number more than
# SPLIT_ROWS, the part of it whose first rows lie in one window of
# GROUP_ROWS sorted rows.
GROUP_ROWS, SPLIT_ROWS = 512, 2048


# Operations and bytes of one launch of each entry (the bound of the
# ``kernels`` line of ``chip_smoke.py`` and of the dry run's kernel counts):
# every input read once, every output written once.
def segment_sum_cost(e: int, d: int, n: int) -> tuple[int, int]:
    """``segment_sum``: one add per element; the sorted rows and their ids
    read, [n, d] written."""
    return e * d, e * (4 * d + 4) + n * d * 4


def segment_offsets_cost(e: int, n: int) -> tuple[int, int]:
    """``segment_offsets``: a compare per row and per boundary; the ids
    read, n + 1 offsets written."""
    return e + n, e * 4 + (n + 1) * 4


def sum_through_cost(e: int, d: int, n: int) -> tuple[int, int]:
    """``segment_sum_edges`` and ``segment_sum_gather_bwd`` (a sum through
    a layout): one add per element; the rows and their order read, the
    offsets read, [n, d] written."""
    return e * d, e * (4 * d + 4) + 4 * (n + 1) + 4 * n * d


def attraction_sum_cost(n: int, kept: int, size: int = 4) -> tuple[int, int]:
    """``attraction_sum`` in a layout type of ``size`` bytes an element: 6
    operations per kept row (two subtracts, two multiplies, two adds); each
    kept row's int32 destination and its weight read (its destination's
    position from cache), each node's position and int32 offset read and
    force written."""
    return 6 * kept, kept * (4 + size) + n * (4 + 4 * size)


@dataclass(frozen=True)
class SegmentLayout:
    """The rows of an id array grouped by segment, built once
    (``segment_layout``) and summed through by every launch that takes it.

    ``perm``: int32 [E], the stable order of the rows by id, or None when
    the ids were given sorted. ``offsets``: int32 [N + 1], ``offsets[s]``
    the first sorted row whose id is ≥ s; rows with ids < 0 or ≥ N lie
    outside every ``[offsets[s], offsets[s + 1])``. ``ids``: the int32 ids
    it was built from (not copied), which the sum's backward gathers
    through. ``groups``: int32, the first segment of each group
    (``segment_groups``), the narrow kernels' warps."""

    perm: torch.Tensor | None
    offsets: torch.Tensor
    ids: torch.Tensor
    groups: torch.Tensor

    @property
    def n_segments(self) -> int:
        return self.offsets.numel() - 1


def segment_layout(ids, n_segments: int, sorted: bool = False) -> SegmentLayout:
    """The ``SegmentLayout`` of [E] int ids over ``n_segments`` segments.
    ``sorted`` promises ascending ids (no sort, no ``perm``). On the card:
    one stable sort, its order cast to int32 once, and the offsets written
    by K7's ``segment_offsets`` entry (``searchsorted`` on the CPU)."""
    ids = ids.to(torch.int32).contiguous()
    e = ids.shape[0]
    if e >= 2**31 or not 0 <= n_segments < 2**31 - 1:
        raise ValueError(f"segment_layout: {e} rows into {n_segments} segments, the kernel "
                         "takes fewer than 2**31 of each")
    if sorted:
        sid, perm = ids, None
    else:
        sid, order = torch.sort(ids, stable=True)
        perm = order.to(torch.int32)
    offsets = segment_offsets(sid, n_segments)
    return SegmentLayout(perm, offsets, ids, segment_groups(offsets, e))


def segment_offsets(sid, n_segments: int):
    """int32 [N + 1] offsets of the ascending int32 ids ``sid``:
    ``offsets[s]`` the first row whose id is ≥ s. K7's ``segment_offsets``
    entry on the card (a thread writes the boundaries of 4 rows),
    ``searchsorted`` on the CPU."""
    dev = sid.device
    form = build.route(sid, "segment_offsets")
    if form == "plain":
        return segment_offsets_ref(sid, n_segments)
    e = sid.shape[0]
    build.require(sid, "sid", torch.int32, dev, (e,))
    offsets = torch.empty(n_segments + 1, dtype=torch.int32, device=dev)
    if form == "rule":
        return build.rule("segment_offsets", offsets, *segment_offsets_cost(e, n_segments))
    fn = build.entry("segment_sum", _OFFSETS_ARGTYPES, "segment_offsets")
    with torch.cuda.device(dev):
        code = fn(build.ptr(sid), e, n_segments, build.ptr(offsets), build.stream(dev))
    build.check("segment_sum", code)
    build.LAUNCHES["segment_offsets"] += 1
    return offsets


def segment_groups(offsets, rows: int):
    """The segments cut into the narrow kernels' warps: blocks of 32
    consecutive segments, each block of more than SPLIT_ROWS rows cut
    further wherever a segment's first row enters a new window of
    GROUP_ROWS rows. int32 [G + 1], the first segment of each group, then N
    (the unused tail of the bound G = N // 32 + 1 + rows // GROUP_ROWS holds
    N too: empty groups). So a run of long segments (a supergraph's large
    communities) spreads over warps of its own, and short ones stay 32 to
    a warp. Plain torch on either device, no host sync (the bound sizes the
    array); each group's start is the least segment of its group id, a min
    that does not depend on the order of the writes."""
    n = offsets.numel() - 1
    dev = offsets.device
    seg = torch.arange(n, device=dev)
    first = offsets[:-1].long()
    block_end = offsets[torch.clamp((seg // 32 + 1) * 32, max=n)].long()
    heavy = block_end - first[seg // 32 * 32] > SPLIT_ROWS
    window = first // GROUP_ROWS
    starts = seg % 32 == 0
    starts[1:] |= heavy[1:] & (window[1:] != window[:-1])
    bound = n // 32 + 1 + rows // GROUP_ROWS
    groups = torch.full((bound + 1,), n, dtype=torch.int64, device=dev)
    groups.scatter_reduce_(0, torch.cumsum(starts, 0) - 1, seg, "amin")
    return groups.to(torch.int32)


def segment_sum(data, seg_ids, n_segments: int, indices_are_sorted: bool = False):
    """``out[seg[e]] += data[e]``: [E, D] (or [E]) data, [E] int32 ids →
    [n_segments, D], summed in float32; ids outside ``[0, n_segments)`` are
    dropped.

    ``indices_are_sorted`` promises ascending ids; without it the kernel's
    input is first sorted stably by id (each segment keeps its row order,
    so the sum is the same either way).
    """
    dev = data.device
    form = build.route(data, "segment_sum")
    if form == "plain":
        return segment_sum_ref(data, seg_ids, n_segments, indices_are_sorted)
    e = data.shape[0]
    if e >= 2**31:
        raise ValueError(f"segment_sum: {e} rows, the kernel takes fewer than 2**31")
    x = data.to(torch.float32).reshape(e, -1)
    build.require(seg_ids, "seg_ids", torch.int32, dev, (e,))
    if not indices_are_sorted:
        order = torch.argsort(seg_ids, stable=True)
        x, seg_ids = x[order], seg_ids[order]
    x = x.contiguous()
    d = x.shape[1]
    out = torch.empty((n_segments, d), dtype=torch.float32, device=dev)
    if form == "rule":
        out = build.rule("segment_sum", out, *segment_sum_cost(e, d, n_segments))
        return out.reshape((n_segments,) + tuple(data.shape[1:])).to(data.dtype)
    fn = build.entry("segment_sum", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(build.ptr(x), build.ptr(seg_ids), e, d, n_segments,
                  build.ptr(out), build.stream(dev))
    build.check("segment_sum", code)
    build.LAUNCHES["segment_sum"] += 1
    return out.reshape((n_segments,) + tuple(data.shape[1:])).to(data.dtype)


def segment_sum_edges(data, ids_or_layout, n_segments: int):
    """``segment_sum`` for per-edge terms through a ``SegmentLayout`` (one
    is built for this call from bare ids), counted under its own name, and
    differentiable in ``data``: the gradient of row ``e`` is the output
    gradient of row ``seg[e]``, or 0 where ``seg[e]`` is dropped."""
    if isinstance(ids_or_layout, SegmentLayout):
        layout = ids_or_layout
        _check_layout(layout, n_segments, data.shape[0], "segment_sum_edges")
    else:
        layout = segment_layout(ids_or_layout, n_segments)
    return _SegmentSumEdges.apply(data, layout)


def gather_rows(x, idx, layout: SegmentLayout | None = None):
    """``x[idx]`` with ids clamped into ``[0, len(x))`` (the edge padding's
    trash id reads the last row), differentiable in ``x``: the gradient of
    each row is the sum of the gradients of the edges whose id is that row,
    added in edge order (K7 on the card), through ``layout`` (the layout of
    ``idx`` over ``len(x)`` rows; built in the backward pass when not given).
    An id outside the range sends its gradient nowhere, as the transpose of
    the reference's clamped gather does (the reference's gradient of
    ``x[idx]``)."""
    if layout is not None:
        _check_layout(layout, x.shape[0], idx.shape[0], "gather_rows")
    return _GatherRows.apply(x, idx, layout)


def attraction_sum(pos, dst, w, layout: SegmentLayout):
    """FA2's attraction through the layout of the sorted sources (built
    with ``sorted=True``): for node s, ``Σ w[r]·(pos_ext[dst[r]] − pos[s])``
    over r in ``[offsets[s], offsets[s + 1])``, in row order; ``pos_ext`` is
    ``pos`` [n, 2] with a zero row n, ``dst`` clamped into ``[0, n]``. →
    [n, 2]. On the card K7's ``attraction_sum`` entry forms each term as it
    adds it. ``pos`` and ``w`` are of the layout's type (float32, bfloat16
    or float16, both the same), read in it; the terms and sums are float32
    and each node's sum is rounded once to that type, which the result
    takes."""
    dev = pos.device
    n, e = pos.shape[0], dst.shape[0]
    if layout.perm is not None or layout.n_segments != n:
        raise ValueError(f"attraction_sum: expected the layout of {n} nodes' sorted sources")
    form = build.route(pos, "attraction_sum")
    if form == "plain":
        return attraction_sum_ref(pos, dst, w, layout.offsets)
    dtype = pos.dtype
    if dtype not in build.FLOAT_CODES:
        raise TypeError(f"pos: dtype {dtype}, expected one of {tuple(build.FLOAT_CODES)}")
    build.require(pos, "pos", dtype, dev, (n, 2))
    build.require(dst, "dst", torch.int32, dev, (e,))
    build.require(w, "w", dtype, dev, (e,))
    build.require(layout.offsets, "offsets", torch.int32, dev, (n + 1,))
    groups = layout.groups
    build.require(groups, "groups", torch.int32, dev)
    out = torch.empty((n, 2), dtype=dtype, device=dev)
    if form == "rule":
        return build.rule("attraction_sum", out, *attraction_sum_cost(n, e, pos.element_size()))
    fn = build.entry("segment_sum", _ATTRACTION_ARGTYPES, "attraction_sum")
    with torch.cuda.device(dev):
        code = fn(build.ptr(pos), build.ptr(dst), build.ptr(w), build.ptr(layout.offsets),
                  build.ptr(groups), groups.numel() - 1, n, build.FLOAT_CODES[dtype],
                  build.ptr(out), build.stream(dev))
    build.check("segment_sum", code)
    build.LAUNCHES["attraction_sum"] += 1
    return out


class _SegmentSumEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, layout):
        ctx.layout = layout
        return _sum_through(data, layout, "segment_sum_edges")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        seg = ctx.layout.ids
        keep = (seg >= 0) & (seg < ctx.layout.n_segments)
        out = grad[torch.where(keep, seg, 0).long()]
        # In place: at E = 61.9 M edges of 64 floats a second [E, D] tensor
        # is 15.8 GB.
        out.masked_fill_(~keep.reshape((-1,) + (1,) * (out.dim() - 1)), 0)
        return out, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, layout):
        ctx.save_for_backward(idx)
        ctx.layout = layout
        ctx.n_rows = x.shape[0]
        return x[torch.clamp(idx.long(), 0, x.shape[0] - 1)]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        layout = ctx.layout if ctx.layout is not None else segment_layout(idx, ctx.n_rows)
        return _sum_through(grad, layout, "segment_sum_gather_bwd"), None, None


def _check_layout(layout, n_segments: int, rows: int, what: str) -> None:
    if layout.n_segments != n_segments or layout.ids.shape[0] != rows:
        raise ValueError(f"{what}: a layout of {layout.ids.shape[0]} rows into "
                         f"{layout.n_segments} segments, expected {rows} into {n_segments}")


def _sum_through(data, layout: SegmentLayout, counter: str):
    """[E, ...] data summed through ``layout`` → [N, ...]: the plain version
    on the CPU, K7's ``segment_sum_layout`` entry on the card."""
    dev = data.device
    e, n = data.shape[0], layout.n_segments
    form = build.route(data, counter)
    if form == "plain":
        return segment_sum_layout_ref(data, layout.perm, layout.offsets)
    d = math.prod(data.shape[1:])
    x = data.to(torch.float32).reshape(e, d).contiguous()
    build.require(layout.offsets, "offsets", torch.int32, dev, (n + 1,))
    if layout.perm is not None:
        build.require(layout.perm, "perm", torch.int32, dev, (e,))
    groups = layout.groups
    build.require(groups, "groups", torch.int32, dev)
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if form == "rule":
        out = build.rule(counter, out, *sum_through_cost(e, d, n))
        return out.reshape((n,) + tuple(data.shape[1:])).to(data.dtype)
    perm = ctypes.c_void_p(None) if layout.perm is None else build.ptr(layout.perm)
    fn = build.entry("segment_sum", _LAYOUT_ARGTYPES, "segment_sum_layout")
    with torch.cuda.device(dev):
        code = fn(build.ptr(x), perm, build.ptr(layout.offsets), build.ptr(groups),
                  groups.numel() - 1, e, d, n, build.ptr(out), build.stream(dev))
    build.check("segment_sum", code)
    build.LAUNCHES[counter] += 1
    return out.reshape((n,) + tuple(data.shape[1:])).to(data.dtype)

