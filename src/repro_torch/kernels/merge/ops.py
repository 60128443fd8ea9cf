"""Public wrappers for sorted-merge-and-combine: kernel K1
(``csrc/merge_scatter.cu``) for CUDA tensors, the plain PyTorch versions
(``ref.py``) for CPU tensors. A tensor anywhere else raises.

``merge_combine`` places its ranked runs with ``merge_place`` (K1 on the
main path). ``scatter_combine`` is the generic scatter for arbitrary
positions, the second entry of the same library, on no path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.merge.ref import (
    merge_combine_ref,
    merge_place_ref,
    scatter_combine_ref,
)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] + [
    ctypes.c_void_p
] * 4
_RUN = [ctypes.c_void_p] * 4 + [ctypes.c_int]
_PLACE_ARGTYPES = _RUN + _RUN + [ctypes.c_int] + [ctypes.c_void_p] * 4


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
    build.LAUNCHES["scatter_combine"] += 1
    return oa, ob, ow


def merge_place(pos_s, sa, sb, sw, pos_c, ca, cb, cw, cap: int):
    """Place the rows of two ranked runs in ``cap`` slots (contract of
    ``ref.merge_place_ref``): slot p takes the keys' max and the weights'
    sum from +0.0 (state row, then chunk row) of the rows ranked p; unhit
    slots return (-1, -1, +0.0).

    ``pos_s``/``sa``/``sb`` [ns] int32 and ``sw`` [ns] float32 are the
    state run, ``pos_c``/``ca``/``cb``/``cw`` [nc] the chunk run. Within
    each run the ranks must be nondecreasing, strictly increasing below
    ``cap``, as ``ref.merge_positions`` gives them.
    """
    dev = pos_s.device
    if dev.type == "cpu":
        return merge_place_ref(pos_s, sa, sb, sw, pos_c, ca, cb, cw, cap)
    if dev.type != "cuda":
        raise ValueError(f"merge_place: unsupported device {dev}")
    ns, nc = pos_s.shape[0], pos_c.shape[0]
    for name, t, dt, n in (("pos_s", pos_s, torch.int32, ns), ("sa", sa, torch.int32, ns),
                           ("sb", sb, torch.int32, ns), ("sw", sw, torch.float32, ns),
                           ("pos_c", pos_c, torch.int32, nc), ("ca", ca, torch.int32, nc),
                           ("cb", cb, torch.int32, nc), ("cw", cw, torch.float32, nc)):
        build.require(t, name, dt, dev, (n,))
    oa = torch.empty(cap, dtype=torch.int32, device=dev)  # every slot is written
    ob = torch.empty(cap, dtype=torch.int32, device=dev)
    ow = torch.empty(cap, dtype=torch.float32, device=dev)
    fn = build.entry("merge_scatter", _PLACE_ARGTYPES, "merge_place")
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos_s), build.ptr(sa), build.ptr(sb), build.ptr(sw), ns,
            build.ptr(pos_c), build.ptr(ca), build.ptr(cb), build.ptr(cw), nc, cap,
            build.ptr(oa), build.ptr(ob), build.ptr(ow), build.stream(dev),
        )
    build.check("merge_scatter", code)
    build.LAUNCHES["merge_scatter"] += 1
    return oa, ob, ow


def merge_combine(sa, sb, sw, ca, cb, cw, s_cap: int):
    """Merge a sorted deduped chunk run [C] into the sorted state run [cap]
    (contract of ``ref.merge_combine_ref``), placing the rows with
    ``merge_place``."""
    return merge_combine_ref(sa, sb, sw, ca, cb, cw, s_cap, place=merge_place)
