"""Gradient compression for the data-parallel all-reduce: the int8
round trip (the wire format of a compressed all-reduce) and top-k
sparsification with error feedback (deep gradient compression), the
reference's ``train/compression.py``.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import _dq8, _q8


def compress_decompress(g: torch.Tensor, mesh=None, axes=()) -> torch.Tensor:
    """Row-wise int8 round trip; non-float tensors pass through. With
    ``mesh`` ``g`` is a block whose last dim is split over ``axes``: the
    row maxima are taken over them."""
    if not g.is_floating_point():
        return g
    q, s = _q8(g, mesh, axes)
    return _dq8(q, s, g.shape).to(g.dtype)


def topk_sparsify(g: torch.Tensor, error: torch.Tensor, k_frac: float = 0.01):
    """Returns ``(sparse_g, new_error)``: ``sparse_g`` keeps the ``k_frac``
    largest magnitudes of ``g + error``; the rest goes into the error.

    Ties break toward the lower index, as the reference's ``top_k``'s do: a stable
    descending sort keeps equal magnitudes in index order (``torch.topk``
    promises no order among them)."""
    acc = g + error
    flat = acc.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices[:k]
    mask = torch.zeros_like(flat, dtype=torch.bool)
    mask[idx] = True
    kept = torch.where(mask, flat, torch.zeros((), dtype=flat.dtype, device=flat.device))
    kept = kept.reshape(g.shape)
    return kept, acc - kept
