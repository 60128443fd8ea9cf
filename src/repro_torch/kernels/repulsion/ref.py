"""Plain PyTorch versions of FA2 degree-weighted n-body repulsion (kernel K2).

    f_i = Σ_{j≠i} kr · m_i · m_j · (x_i − x_j) / d_ij²

with the supernode variant shifting the interaction distance by the two
radii (paper §4.1: big communities get space ∝ √size):

    d'_ij = max(d_ij − r_i − r_j, ε)
    f_i   = Σ kr · m_i · m_j · û_ij / d'_ij

``repulsion_ref`` is the dense [n, n] form; ``repulsion_chunked`` walks j
in fixed chunks with the same per-pair arithmetic, so its live memory is
O(n · chunk) — the form the CPU runs above 2048 nodes and the plain
version the chip smoke holds the kernel against at full width.
``repulsion_chunked_rows`` is rows ``[i0, i0 + nl)`` of it (the sharded
layout's form), bitwise those rows: each row's sum runs over the same
j-chunks in the same order whichever rows are computed beside it.

A half-width layout (bfloat16, float16) is widened to float32, computed as
a float32 layout is and rounded once to its type, as the kernel does; a
float32 layout's forces are the same bits as before that rule.
"""
from __future__ import annotations

import torch

EPS = 1e-4


def _pair_sum(pi, mi, ri, pj, mj, rj, same, kr: float, use_radii: bool):
    """Σ_j of one [ni, nj] block of pair forces → [ni, 2]."""
    dx = pi[:, 0:1] - pj[None, :, 0]
    dy = pi[:, 1:2] - pj[None, :, 1]
    d2 = dx * dx + dy * dy
    d = torch.sqrt(torch.clamp(d2, min=EPS * EPS))
    if use_radii:
        eff = torch.clamp(d - ri[:, None] - rj[None, :], min=EPS)
    else:
        eff = torch.clamp(d, min=EPS)
    mag = kr * mi[:, None] * mj[None, :] / (eff * d)
    mag = torch.where(same, 0.0, mag)
    return torch.stack([(mag * dx).sum(1), (mag * dy).sum(1)], dim=1)


def _widened(pos, mass, radii):
    """``(pos, mass, r)``: the inputs in the type the sums run in
    (float32 for a half-width layout, the inputs' own otherwise), ``r`` the
    radii or, without them, the mass (a placeholder no pair reads)."""
    wide = torch.promote_types(pos.dtype, torch.float32)
    pos, mass = pos.to(wide), mass.to(wide)
    r = radii.to(wide) if radii is not None else mass
    return pos, mass, r


def repulsion_ref(pos, mass, kr: float, radii=None):
    """O(n²) dense reference. pos [n,2], mass [n] → forces [n,2]."""
    n = pos.shape[0]
    dtype = pos.dtype
    pos, mass, r = _widened(pos, mass, radii)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    return _pair_sum(pos, mass, r, pos, mass, r, eye, kr, radii is not None).to(dtype)


def repulsion_chunked(pos, mass, kr: float, radii=None, chunk: int = 1024):
    """j-chunked form of ``repulsion_ref``: same math, O(n·chunk) memory."""
    n = pos.shape[0]
    dtype = pos.dtype
    pos, mass, r = _widened(pos, mass, radii)
    idx = torch.arange(n, device=pos.device)
    acc = torch.zeros((n, 2), dtype=pos.dtype, device=pos.device)
    for j0 in range(0, n, chunk):
        j1 = min(n, j0 + chunk)
        same = idx[:, None] == idx[None, j0:j1]
        acc += _pair_sum(
            pos, mass, r, pos[j0:j1], mass[j0:j1], r[j0:j1], same, kr,
            radii is not None,
        )
    return acc.to(dtype)


def repulsion_chunked_rows(pos, mass, i0: int, nl: int, kr: float, radii=None,
                           chunk: int = 1024):
    """Rows ``[i0, i0 + nl)`` of ``repulsion_chunked`` → [nl, 2], without
    the other rows: the same j-chunks, per-pair arithmetic and in-chunk
    sums, with the self pair masked by global index. Keep the body in
    lockstep with ``repulsion_chunked``: the sharded layout's bitwise
    agreement with one rank rests on it."""
    n = pos.shape[0]
    dtype = pos.dtype
    pos, mass, r = _widened(pos, mass, radii)
    rows = slice(i0, i0 + nl)
    idx = torch.arange(n, device=pos.device)
    acc = torch.zeros((nl, 2), dtype=pos.dtype, device=pos.device)
    for j0 in range(0, n, chunk):
        j1 = min(n, j0 + chunk)
        same = idx[rows, None] == idx[None, j0:j1]
        acc += _pair_sum(
            pos[rows], mass[rows], r[rows], pos[j0:j1], mass[j0:j1], r[j0:j1],
            same, kr, radii is not None,
        )
    return acc.to(dtype)
