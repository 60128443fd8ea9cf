"""Public wrapper for FA2 n-body repulsion: kernel K2
(``csrc/repulsion_nbody.cu``) for CUDA tensors; on the CPU the dense plain
version up to 2048 nodes and the j-chunked one above. A tensor anywhere
else raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.repulsion.ref import repulsion_chunked, repulsion_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float, ctypes.c_int] + [
    ctypes.c_void_p
] * 2


def repulsion(pos, mass, kr: float, radii=None):
    """FA2 repulsion forces. pos [n,2], mass [n] (radii [n] or None) → [n,2].

    Padded entries must carry mass 0 (they then exert/receive no force).
    """
    dev = pos.device
    n = pos.shape[0]
    if dev.type == "cpu":
        if n <= 2048:
            return repulsion_ref(pos, mass, kr, radii=radii)
        return repulsion_chunked(pos, mass, kr, radii=radii)
    if dev.type != "cuda":
        raise ValueError(f"repulsion: unsupported device {dev}")
    build.require(pos, "pos", torch.float32, dev, (n, 2))
    build.require(mass, "mass", torch.float32, dev, (n,))
    if radii is not None:
        build.require(radii, "radii", torch.float32, dev, (n,))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    fn = build.entry("repulsion_nbody", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(
            build.ptr(pos), build.ptr(mass),
            build.ptr(radii) if radii is not None else None,
            n, float(kr), int(radii is not None), build.ptr(out),
            build.stream(dev),
        )
    build.check("repulsion_nbody", code)
    build.LAUNCHES["repulsion_nbody"] += 1
    return out
