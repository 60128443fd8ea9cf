"""Public wrapper for the count–min sketch update: hashes the keys with the
family of ``core/cms.py`` and adds their weights through kernel K8
(``csrc/cms_update.cu``) for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors. A tensor anywhere else raises.

``core/cms.update`` does not call this: it stays one ``index_put_``, as the
reference's stays a scatter, until a measurement on the card shows the
kernel winning (ROADMAP.md, TPU kernels, item 8).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import cms as cms_lib
from repro_torch.kernels import build
from repro_torch.kernels.cms.ref import cms_update_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def hashed_buckets(keys, cfg: cms_lib.CMSConfig):
    """[rows, n] int32 buckets of ``keys``; −1 in every row where key < 0."""
    a, b = cms_lib.hash_params(cfg)
    h = cms_lib.hash_keys(keys, a, b, cfg.cols)
    return torch.where(keys[None, :] >= 0, h, -1).to(torch.int32)


def update_hashed(sketch, h, w):
    """``sketch`` [rows, cols] + ``w`` [n] at buckets ``h`` [rows, n] int32
    (outside ``[0, cols)`` dropped) → a new sketch."""
    dev = sketch.device
    if dev.type == "cpu":
        return cms_update_ref(sketch, h, w)
    if dev.type != "cuda":
        raise ValueError(f"cms update: unsupported device {dev}")
    rows, cols = sketch.shape
    n = h.shape[1]
    build.require(sketch, "sketch", torch.float32, dev, (rows, cols))
    build.require(h, "h", torch.int32, dev, (rows, n))
    build.require(w, "w", torch.float32, dev, (n,))
    out = sketch.clone()
    fn = build.entry("cms_update", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(build.ptr(h), build.ptr(w), rows, n, cols, build.ptr(out),
                  build.stream(dev))
    build.check("cms_update", code)
    build.LAUNCHES["cms_update"] += 1
    return out


def update(sketch, keys, weights, cfg: cms_lib.CMSConfig):
    """Add ``weights`` at ``keys`` (negative keys are padding and add
    nothing). Returns a new sketch."""
    return update_hashed(sketch, hashed_buckets(keys, cfg),
                         weights.to(torch.float32).contiguous())
