"""Public wrapper for sorted-merge-and-combine: kernel K1
(``csrc/merge_scatter.cu``) for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors. A tensor anywhere else raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.merge.ref import merge_combine_ref, scatter_combine_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [
    ctypes.c_void_p
] * 4


def scatter_combine(pos, a, b, w, cap: int):
    """Place rows at their output positions (keys by max, weights by +).

    ``pos``/``a``/``b`` [N] int32, ``w`` [N] float32. Rows outside
    ``[0, cap)`` are dropped; unhit slots return keys -1 and weight 0.
    """
    dev = pos.device
    if dev.type == "cpu":
        return scatter_combine_ref(pos, a, b, w, cap)
    if dev.type != "cuda":
        raise ValueError(f"scatter_combine: unsupported device {dev}")
    n = pos.shape[0]
    build.require(pos, "pos", torch.int32, dev, (n,))
    build.require(a, "a", torch.int32, dev, (n,))
    build.require(b, "b", torch.int32, dev, (n,))
    build.require(w, "w", torch.float32, dev, (n,))
    oa = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    ob = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    ow = torch.zeros(cap, dtype=torch.float32, device=dev)
    fn = build.entry("merge_scatter", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(a), build.ptr(b), build.ptr(w), n, cap,
            build.ptr(oa), build.ptr(ob), build.ptr(ow), build.stream(dev),
        )
    build.check("merge_scatter", code)
    build.LAUNCHES["merge_scatter"] += 1
    return oa, ob, ow


def merge_combine(sa, sb, sw, ca, cb, cw, s_cap: int):
    """Merge a sorted deduped chunk run [C] into the sorted state run [cap]
    (contract of ``ref.merge_combine_ref``), placing the rows with
    ``scatter_combine``."""
    return merge_combine_ref(sa, sb, sw, ca, cb, cw, s_cap, scatter=scatter_combine)
