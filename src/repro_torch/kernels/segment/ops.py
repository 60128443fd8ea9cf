"""Public wrappers for the segment sum: kernel K7 (``csrc/segment_sum.cu``)
for CUDA tensors, the plain PyTorch version (``ref.py``) for CPU tensors.
A tensor anywhere else raises.

Two entries launch the same kernel and count apart: ``segment_sum`` (the
grid repulsion's cell statistics) and ``segment_sum_edges`` (per-edge terms
summed into their nodes: FA2's attraction and the GNN's message sums). On
the card both add each segment in row order, so their sums are the same
bits from run to run, where ``index_add_`` would add on float atomics.

``segment_sum_edges`` and ``gather_rows`` (the GNN's row gather) are
``torch.autograd.Function``s on both devices, each the other's transpose:
the sum's backward gathers the output gradient back onto the edges (the
transpose of the reference's segment sum, plain torch), and the
gather's backward sums the edge gradients into their rows through K7,
counted under ``segment_sum_gather_bwd``. Autograd's own backward for
``x[idx]`` would add on float atomics; this one keeps a training step on
the card the same bits from run to run.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment.ref import segment_sum_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def segment_sum(data, seg_ids, n_segments: int, indices_are_sorted: bool = False):
    """``out[seg[e]] += data[e]``: [E, D] (or [E]) data, [E] int32 ids →
    [n_segments, D], summed in float32; ids outside ``[0, n_segments)`` are
    dropped.

    ``indices_are_sorted`` promises ascending ids; without it the kernel's
    input is first sorted stably by id (each segment keeps its row order,
    so the sum is the same either way).
    """
    return _segment_sum(data, seg_ids, n_segments, indices_are_sorted, "segment_sum")


def segment_sum_edges(data, seg_ids, n_segments: int, indices_are_sorted: bool = False):
    """``segment_sum`` for per-edge terms, counted under its own name, and
    differentiable in ``data``: the gradient of row ``e`` is the output
    gradient of row ``seg[e]``, or 0 where ``seg[e]`` is dropped."""
    return _SegmentSumEdges.apply(data, seg_ids, n_segments, indices_are_sorted)


def gather_rows(x, idx):
    """``x[idx]`` with ids clamped into ``[0, len(x))`` (the edge padding's
    trash id reads the last row), differentiable in ``x``: the gradient of
    each row is the sum of the gradients of the edges whose id is that row,
    added in edge order (K7 on the card). An id outside the range sends its
    gradient nowhere, as the transpose of the reference's clamped gather
    does (the reference's gradient of ``x[idx]``)."""
    return _GatherRows.apply(x, idx)


class _SegmentSumEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, n_segments, indices_are_sorted):
        ctx.save_for_backward(seg_ids)
        ctx.n_segments = n_segments
        return _segment_sum(data, seg_ids, n_segments, indices_are_sorted, "segment_sum_edges")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (seg,) = ctx.saved_tensors
        keep = (seg >= 0) & (seg < ctx.n_segments)
        out = grad[torch.where(keep, seg, 0).long()]
        # In place: at E = 61.9 M edges of 64 floats a second [E, D] tensor
        # is 15.8 GB.
        out.masked_fill_(~keep.reshape((-1,) + (1,) * (out.dim() - 1)), 0)
        return out, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        return x[torch.clamp(idx, 0, x.shape[0] - 1)]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _segment_sum(grad, idx.to(torch.int32).contiguous(), ctx.n_rows, False,
                            "segment_sum_gather_bwd"), None


def _segment_sum(data, seg_ids, n_segments: int, indices_are_sorted: bool, counter: str):
    dev = data.device
    if dev.type == "cpu":
        return segment_sum_ref(data, seg_ids, n_segments, indices_are_sorted)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {dev}")
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
    fn = build.entry("segment_sum", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(build.ptr(x), build.ptr(seg_ids), e, d, n_segments,
                  build.ptr(out), build.stream(dev))
    build.check("segment_sum", code)
    build.LAUNCHES[counter] += 1
    return out.reshape((n_segments,) + tuple(data.shape[1:])).to(data.dtype)
