"""Public wrappers for the count–min sketch update, kernel K8
(``csrc/cms_update.cu``) for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors. A tensor anywhere else raises.

- ``update`` takes the keys and hashes them inside the kernel with the
  family of ``core/cms.py``. ``core.cms.update`` calls it for every CUDA
  sketch, so K8 runs once per main-path run, in the supergraph pass.
- ``update_hashed`` takes buckets already hashed, the TPU kernel's contract.

A fake tensor takes the abstract rule (``build.route``): the scratch and
the new sketch the card's call allocates, and ``update_cost`` /
``update_hashed_cost`` of the launch. A rule cannot read the keys, so it
counts every (row, key) slot as kept, the most a launch adds.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import cms as cms_lib
from repro_torch.kernels import build
from repro_torch.kernels.cms.ref import cms_update_ref

_HASHED_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int] + [ctypes.c_void_p] * 4
_KEYS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_int] + [ctypes.c_void_p] * 4


def update_cost(n: int, rows: int, cols: int, kept: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one keys-in ``update`` launch: one add per
    kept (row, key) slot (every slot when ``kept`` is None); each key and
    weight read once, the sketch read and written."""
    return rows * n if kept is None else kept, n * 8 + 2 * rows * cols * 4


def update_hashed_cost(n: int, rows: int, cols: int, kept: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one ``update_hashed`` launch: one add per kept
    bucket; the [rows, n] buckets and the weights read once, the sketch
    read and written."""
    return rows * n if kept is None else kept, rows * n * 4 + n * 4 + 2 * rows * cols * 4


def hashed_buckets(keys, cfg: cms_lib.CMSConfig):
    """[rows, n] int32 buckets of ``keys``; −1 in every row where key < 0."""
    a, b = cms_lib.hash_params(cfg)
    h = cms_lib.hash_keys(keys, a, b, cfg.cols)
    return torch.where(keys[None, :] >= 0, h, -1).to(torch.int32)


def _launch(symbol, argtypes, head, rows, n, cols, w, sketch, form="cuda"):
    """Run one K8 entry into a fresh sketch; ``head`` are its leading
    pointers (buckets or keys, and the hash constants). ``form`` "rule":
    the allocations only (``build.route``)."""
    dev = sketch.device
    scratch = torch.zeros(3 * rows * cols, dtype=torch.int32, device=dev)
    out = torch.empty_like(sketch)
    if form == "rule":
        del scratch
        cost = (update_cost if symbol == "cms_update_keys" else update_hashed_cost)(n, rows, cols)
        return build.rule(symbol, out, *cost)
    fn = build.entry("cms_update", argtypes, symbol)
    with torch.cuda.device(dev):
        code = fn(*head, build.ptr(w), rows, n, cols, build.ptr(sketch),
                  build.ptr(scratch), build.ptr(out), build.stream(dev))
    build.check("cms_update", code)
    build.LAUNCHES[symbol] += 1
    return out


def update_hashed(sketch, h, w):
    """``sketch`` [rows, cols] + ``w`` [n] at buckets ``h`` [rows, n] int32
    (outside ``[0, cols)`` dropped) → a new sketch."""
    dev = sketch.device
    form = build.route(sketch, "cms update")
    if form == "plain":
        return cms_update_ref(sketch, h, w)
    rows, cols = sketch.shape
    n = h.shape[1]
    build.require(sketch, "sketch", torch.float32, dev, (rows, cols))
    build.require(h, "h", torch.int32, dev, (rows, n))
    build.require(w, "w", torch.float32, dev, (n,))
    head = (build.ptr(h),) if form == "cuda" else ()
    return _launch("cms_update", _HASHED_ARGTYPES, head, rows, n, cols, w, sketch, form)


def update(sketch, keys, weights, cfg: cms_lib.CMSConfig):
    """Add ``weights`` at ``keys`` (negative keys are padding and add
    nothing). Returns a new sketch."""
    dev = sketch.device
    w = weights.to(torch.float32).contiguous()
    form = build.route(sketch, "cms update")
    if form == "plain":
        return cms_update_ref(sketch, hashed_buckets(keys, cfg), w)
    k = keys.to(torch.int32).contiguous()
    n = k.shape[0]
    build.require(sketch, "sketch", torch.float32, dev, (cfg.rows, cfg.cols))
    build.require(k, "keys", torch.int32, dev, (n,))
    build.require(w, "weights", torch.float32, dev, (n,))
    if form == "rule":
        return _launch("cms_update_keys", _KEYS_ARGTYPES, (), cfg.rows, n, cfg.cols, w, sketch,
                       form)
    # Every row's a, then every row's b: host memory, which the C entry
    # reads into the launch's parameters.
    ab = np.ascontiguousarray(np.concatenate(cms_lib.hash_params(cfg)), dtype=np.uint32)
    head = (build.ptr(k), ctypes.c_void_p(ab.ctypes.data))
    return _launch("cms_update_keys", _KEYS_ARGTYPES, head, cfg.rows, n, cfg.cols, w, sketch)
