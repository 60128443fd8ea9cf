"""AdamW with an optional 8-bit state: int8 row-wise momentum and a
factored (Adafactor-style) second moment, the reference's
``train/optimizer.py`` step for step.

State layout (the reference's, so its checkpoints restore here):
``{"count": int32 [], "mv": {<param path>: {"m": ..., "v": ...}}}``. With
``state_bits=32`` m and v are float32 tensors of the parameter's shape;
with 8, m is ``{"q": int8 [shape], "s": float32 [shape[:-1] + (1,)]}`` and
v of a parameter of rank ≥ 2 is ``{"r": float32 shape[:-1], "c": float32
shape[:-2] + shape[-1:]}`` (row and column means of g²), else a float32
tensor.

``apply_updates`` updates parameters and state in place under
``torch.no_grad()`` and returns the same tensors: the reference donates
both to its step (``donate=(0, 1)``), and a second copy of yi-6b's float32
parameters and moments would not fit next to the first. It takes the
tensors one at a time, and stacked layer tensors one layer slice at a
time, so at most a slice's float32 temporaries are live. The reference
threads its large updates through ``optimization_barrier`` to impose that
order on XLA's schedule; eager torch already runs them in program order,
so nothing here stands for it.

On a ``ModelMesh`` (``apply_updates(..., mesh, specs)``) each rank updates
its blocks of the parameters and of the state (the blocks
``shardings_for_axes`` gives the state over ``opt_logical_axes``, which
are the parameter's: ``state_specs``). The update is elementwise; the
statistics that reduce over a split dim take a collective over the axes
that split it: the int8 row scale's max over the last dim, the factored
second moment's row and column means and ``mean(vr)``, and the global
gradient norm, whose leaves' squares are summed over the axes each leaf is
split on, once. The max is exact; the means and the norm add in another
order than one rank's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.param import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    # 32: float32 m, v (classic AdamW). 8: int8 row-wise momentum and the
    # factored second moment (straight int8 v diverges: small second
    # moments quantize to zero and the updates explode).
    state_bits: int = 32
    grad_clip: float = 1.0


# ------------------------------------------------- row-wise int8 quantizer
#
# One scale per last-dim row: q keeps the parameter's exact shape, the
# scale drops the last dim to 1.

def _q8(x: torch.Tensor, mesh=None, axes=()):
    """Row-wise int8; with ``mesh``, the last dim's max taken over the
    ``axes`` that split it."""
    top = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if mesh is not None and axes:
        from repro_torch.sharding.collectives import all_reduce_axes

        top = all_reduce_axes(top.contiguous(), mesh, axes, "max")
    scale = top / 127.0 + 1e-12
    # torch.round rounds half to even, as jnp.round does.
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape):
    return (q.to(torch.float32) * scale).reshape(shape)


def _vrow_vcol_shapes(shape):
    """Factored v: row stats reduce the last dim, col stats the 2nd-to-last."""
    return tuple(shape[:-1]), tuple(shape[:-2]) + (shape[-1],)


def _factored_ok(shape) -> bool:
    return len(shape) >= 2


def _state_one(shape, cfg: AdamWConfig, make):
    """One parameter's ``{"m", "v"}``, each leaf ``make(shape, dtype)``."""
    f32 = torch.float32
    if cfg.state_bits == 8:
        s_shape = tuple(shape[:-1]) + (1,) if shape else (1,)
        m = {"q": make(tuple(shape), torch.int8), "s": make(s_shape, f32)}
        if _factored_ok(shape):
            vr, vc = _vrow_vcol_shapes(shape)
            v = {"r": make(vr, f32), "c": make(vc, f32)}
        else:
            v = make(tuple(shape), f32)
        return {"m": m, "v": v}
    return {"m": make(tuple(shape), f32), "v": make(tuple(shape), f32)}


def init_opt_state(params, cfg: AdamWConfig):
    """Zero state on the parameters' devices."""
    def one(p):
        # A zero m quantizes to q = 0 and s = 1e-12 (the reference's _q8(0)).
        st = _state_one(p.shape, cfg, lambda s, dt: torch.zeros(s, dtype=dt, device=p.device))
        if cfg.state_bits == 8:
            st["m"]["s"].fill_(1e-12)
        return st

    first = tree_leaves(params)[0]
    return {"count": torch.zeros((), dtype=torch.int32, device=first.device),
            "mv": tree_map(one, params)}


def abstract_opt_state(abstract_params, cfg: AdamWConfig):
    """``meta`` tensors matching ``init_opt_state`` (the dry-run's inputs)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {"count": meta((), torch.int32),
            "mv": tree_map(lambda p: _state_one(p.shape, cfg, meta), abstract_params)}


def opt_logical_axes(param_axes_tree, cfg: AdamWConfig):
    """Logical axes of the optimizer state, mirroring the parameters'
    (tuples are leaves): m and v share the parameter's axes; the int8
    scale keeps all but the reduced last one; factored v its row and
    column axes."""
    def one(axes):
        if cfg.state_bits == 8:
            m = {"q": tuple(axes), "s": (tuple(axes[:-1]) + (None,)) if axes else (None,)}
            if len(axes) >= 2:
                v = {"r": tuple(axes[:-1]), "c": tuple(axes[:-2]) + (axes[-1],)}
            else:
                v = axes
            return {"m": m, "v": v}
        return {"m": axes, "v": axes}

    return {"count": (), "mv": tree_map(one, param_axes_tree)}


def global_norm(tree, mesh=None, specs=None):
    """√(Σ over leaves, in sorted key order, of Σ x²) in float32. With
    ``mesh`` each leaf is a block of ``specs``' leaf: its Σ x² is summed
    over the axes that split it (one all-reduce a distinct set of axes)."""
    leaves = tree_leaves(tree)
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    if mesh is not None and mesh.size > 1:
        from repro_torch.sharding.collectives import all_reduce_axes
        from repro_torch.sharding.rules import spec_axes

        sets: dict = {}
        for i, s in enumerate(tree_leaves(specs)):
            sets.setdefault(mesh.live_axes(spec_axes(s)), []).append(i)
        for axes, idx in sets.items():
            if axes:
                total = all_reduce_axes(torch.stack([sq[i] for i in idx]), mesh, axes)
                for j, i in enumerate(idx):
                    sq[i] = total[j]
    return torch.sqrt(sum(sq))


def state_specs(spec, cfg: AdamWConfig):
    """The specs of one parameter's ``{"m", "v"}`` blocks, from the
    parameter's spec (what ``shardings_for_axes`` gives over
    ``opt_logical_axes``: the same dims keep the same axes)."""
    from repro_torch.sharding.rules import P

    spec = tuple(spec)
    if cfg.state_bits == 8:
        m = {"q": P(*spec), "s": P(*spec[:-1], None) if spec else P(None)}
        v = {"r": P(*spec[:-1]), "c": P(*spec[:-2], spec[-1])} if len(spec) >= 2 else P(*spec)
        return {"m": m, "v": v}
    return {"m": P(*spec), "v": P(*spec)}


def _dim_axes(mesh, spec, dim: int) -> tuple:
    from repro_torch.sharding.rules import entry_axes

    if mesh is None or dim >= len(spec) or -dim > len(spec):
        return ()
    return mesh.live_axes(entry_axes(spec[dim]))


def _mean(x, dim: int, mesh, axes, full: int):
    """``mean`` over ``dim`` of a tensor whose ``dim`` is split over
    ``axes`` (its whole length ``full``)."""
    if not axes:
        return torch.mean(x, dim=dim)
    from repro_torch.sharding.collectives import all_reduce_axes

    return all_reduce_axes(torch.sum(x, dim=dim), mesh, axes) / full


def _slices(p):
    """Views along the leading (layer) dim of a stacked tensor of rank ≥ 3,
    else the whole tensor: every step below is elementwise or reduces the
    last two dims only, so slicing changes no bit."""
    if p.dim() >= 3:
        return list(range(p.shape[0]))
    return [slice(None)]


def _update_one(p, g, mv, cfg: AdamWConfig, clip, b1c, b2c, mesh=None, spec=()):
    """One parameter's AdamW update, in place: p, m, v (or q, s, r, c).
    With ``mesh`` ``p`` is a block of ``spec``."""
    f32 = torch.float32
    last, second = _dim_axes(mesh, spec, -1), _dim_axes(mesh, spec, -2)
    k_last = mesh.extent(last) if last else 1
    k_second = mesh.extent(second) if second else 1
    for sl in _slices(p):
        gs = g[sl].to(f32) * clip
        pf = p[sl].to(f32)
        if cfg.state_bits == 8:
            q, s = mv["m"]["q"][sl], mv["m"]["s"][sl]
            m = cfg.b1 * _dq8(q, s, q.shape) + (1 - cfg.b1) * gs
            q8, s8 = _q8(m, mesh, last)
            q.copy_(q8)
            s.copy_(s8)
        else:
            m = mv["m"][sl]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * gs)
        if cfg.state_bits == 8 and _factored_ok(p.shape):
            vr, vc = mv["v"]["r"][sl], mv["v"]["c"][sl]
            g2 = gs * gs + 1e-30
            full_last, full_second = g2.shape[-1] * k_last, g2.shape[-2] * k_second
            vr.copy_(cfg.b2 * vr + (1 - cfg.b2) * _mean(g2, -1, mesh, last, full_last))
            vc.copy_(cfg.b2 * vc + (1 - cfg.b2) * _mean(g2, -2, mesh, second, full_second))
            # V ≈ (vr ⊗ vc) / mean(vr): the Adafactor rank-1 reconstruction.
            denom = _mean(vr, -1, mesh, second, full_second)[..., None, None] + 1e-30
            v_hat = (vr[..., None] * vc[..., None, :]) / denom
        else:
            v = mv["v"][sl]
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * gs * gs)
            v_hat = v
        update = (m / b1c) / (torch.sqrt(v_hat / b2c) + cfg.eps)
        p[sl] = (pf - cfg.lr * (update + cfg.weight_decay * pf)).to(p.dtype)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, mesh=None, specs=None):
    """One AdamW step, in place. Returns ``(params, state, {"grad_norm"})``
    with the same parameter and state tensors it was given. With ``mesh``
    every leaf is this rank's block of its spec in ``specs`` (the
    parameters' spec tree)."""
    state["count"] += 1
    count = state["count"].to(torch.float32)
    gnorm = global_norm(grads, mesh, specs)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** count
    b2c = 1.0 - cfg.b2 ** count
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_mv = _state_leaves(params, state["mv"])
    flat_s = tree_leaves(specs) if mesh is not None else [()] * len(flat_p)
    for p, g, mv, sp in zip(flat_p, flat_g, flat_mv, flat_s, strict=True):
        _update_one(p, g, mv, cfg, clip, b1c, b2c, mesh, tuple(sp))
    return params, state, {"grad_norm": gnorm}


def _state_leaves(params, mv):
    """Each parameter's ``{"m", "v"}`` dict, in the parameters' leaf order."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _state_leaves(params[k], mv[k])]
    return [mv]
