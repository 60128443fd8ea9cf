"""Public wrappers for the segment sum: kernel K7 (``csrc/segment_sum.cu``)
for CUDA tensors, the plain PyTorch version (``ref.py``) for CPU tensors.
A tensor anywhere else raises.

Two entries launch the same kernel and count apart: ``segment_sum`` (the
grid repulsion's cell statistics) and ``segment_sum_edges`` (per-edge terms
summed into their nodes: FA2's attraction and the GNN's message sums). On
the card both add each segment in row order, so their sums are the same
bits from run to run, where ``index_add_`` would add on float atomics.
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
    """``segment_sum`` for per-edge terms, counted under its own name."""
    return _segment_sum(data, seg_ids, n_segments, indices_are_sorted, "segment_sum_edges")


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
