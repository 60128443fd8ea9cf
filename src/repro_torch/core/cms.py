"""Count–min sketch (paper §3.3) — community sizing without exact counters.

A CMS is a *linear* sketch: updates commute and shards merge by addition.

Hashing: multiply-shift universal hashing modulo 2^32, then mod ``cols``;
the paper uses 4 hash rows and cols ≈ 1e-4 × |E|. torch's uint32 lacks add,
shift and mod on the CPU, so the hash runs in int64: ``((a·k + b) mod 2^32)
>> 5``. The low 32 bits of the int64 product are right even when it wraps,
so the buckets equal the uint32 ones bit for bit.

``update`` on a CUDA sketch runs kernel K8 (``csrc/cms_update.cu``), which
hashes the keys with this family in uint32 and counts integer-valued
weights exactly in int64: the same sketch as the plain version below while
every bucket sum stays under 2^24, and the same from run to run at any size.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CMSConfig:
    rows: int = 4
    cols: int = 5000
    seed: int = 0x5EED


def hash_params(cfg: CMSConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (a, b) multiply-shift constants (odd a), as uint32 numpy —
    drawn from numpy's generator, so the constants match the reference."""
    rng = np.random.default_rng(cfg.seed)
    a = rng.integers(1, 2**31, size=cfg.rows, dtype=np.uint32) * 2 + 1
    b = rng.integers(0, 2**31, size=cfg.rows, dtype=np.uint32)
    return a, b


def hash_keys(keys, a, b, cols: int):
    """[rows, n] int64 bucket indices for int32 keys."""
    dev = keys.device
    k = (keys.long() & 0xFFFFFFFF)[None, :]  # the key's uint32 bit pattern
    at = torch.as_tensor(a.astype(np.int64), device=dev)[:, None]
    bt = torch.as_tensor(b.astype(np.int64), device=dev)[:, None]
    h = ((at * k + bt) & 0xFFFFFFFF) >> 5
    return h % cols


def init_sketch(cfg: CMSConfig, dtype=torch.float32, device="cpu"):
    return torch.zeros((cfg.rows, cfg.cols), dtype=dtype, device=device)


def update(sketch, keys, weights, cfg: CMSConfig):
    """Add ``weights`` at ``keys``; negative-key slots are masked (padding).
    Returns a new sketch.

    A CUDA sketch goes through kernel K8, which hashes the keys itself
    (``kernels.cms.ops.update``), as does a fake one (a dry run: K8's
    abstract rule); a CPU sketch through the plain ``index_put_`` below;
    any other device raises."""
    from repro_torch.kernels import build

    if sketch.device.type != "cpu" or build.is_fake(sketch):
        from repro_torch.kernels.cms import ops  # ops imports this module

        return ops.update(sketch, keys, weights, cfg)
    a, b = hash_params(cfg)
    h = hash_keys(keys, a, b, cfg.cols)
    w = torch.where(keys >= 0, weights, 0).to(sketch.dtype)
    rows = torch.arange(cfg.rows, device=sketch.device)[:, None].expand_as(h)
    out = sketch.clone()
    out.index_put_((rows, h), w[None, :].expand_as(h), accumulate=True)
    return out


def query(sketch, keys, cfg: CMSConfig):
    """Point-query: min over hash rows (classic CMS estimate)."""
    a, b = hash_params(cfg)
    h = hash_keys(keys, a, b, cfg.cols)
    rows = torch.arange(cfg.rows, device=sketch.device)[:, None]
    return sketch[rows, h].min(dim=0).values


def merge(*sketches):
    """CMS is linear: shard-local sketches merge by addition."""
    return functools.reduce(torch.add, sketches)


def sharded_update(sketch, keys, weights, cfg: CMSConfig, mesh):
    """``update`` with the keys spread over ``mesh``: the keys and weights
    (the same on every rank) are padded with the masked key -1 to a
    multiple of D, each rank sketches its contiguous slice (kernel K8 on
    the card) into a zero sketch, and one all-reduce sums the sketches —
    the linearity above. Bitwise the single-rank sketch while every count
    stays integer-valued below 2^24 (community sizes are degree sums);
    above that, or for fractional weights, the float sum's order differs.
    Returns a new sketch, replicated."""
    from repro_torch.sharding.collectives import all_reduce

    d = mesh.size
    pad = (-keys.shape[0]) % d
    if pad:
        keys = torch.cat([keys, torch.full((pad,), -1, dtype=keys.dtype,
                                           device=keys.device)])
        weights = torch.cat([weights, torch.zeros(pad, dtype=weights.dtype,
                                                  device=weights.device)])
    per = keys.shape[0] // d
    r = slice(mesh.rank * per, (mesh.rank + 1) * per)
    local = update(torch.zeros_like(sketch), keys[r].contiguous(),
                   weights[r].contiguous(), cfg)
    return sketch + all_reduce(local, mesh, "sum")


# Chunk-incremental API (core/stream.py engine): the sketch is linear, so
# ``update`` already *is* the chunk step; ``finalize`` is the identity.
init = init_sketch


def finalize(sketch):
    return sketch
