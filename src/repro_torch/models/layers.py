"""Shared neural layers: RMSNorm, RoPE, GQA attention (full / sliding
window / chunked prefill / decode), dense GLU MLP, and capacity-based MoE
with sort dispatch (no [T, E, C] one-hot).

Pure functions over (parameter dict, inputs), written to repeat the
reference's arithmetic step for step (its ``models/layers.py``):
activations in ``act_dtype`` with float32 softmax and norm statistics, the
same masks. Attention stays plain torch ops; the reference has no
accelerator kernel there, and a fused attention call would pick its own
numerics.

On a ``ModelMesh`` (``sharding.params.Placement``): ``vocab_lookup`` reads
a vocab-parallel table, ``moe_mlp_shmap`` is the reference's
expert-parallel MoE, one rank's part of it, and ``attend_partial`` with
``combine_partials`` is attention over a key range split across ranks
(split-K decoding over a sequence-sharded KV cache).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG = torch.finfo(torch.float32).min


# --------------------------------------------------------------- norms / pos

def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """x [..., S, H, hd]; positions [..., S] int32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def _attend_grouped(q, k, v, mask, scale):
    """q [B,Sq,KV,G,hd], k [B,Skv,KV,hd], v same → [B,Sq,KV,G,hd].

    mask [B or 1, Sq, Skv] bool (True = attend). Softmax in float32. The
    decode path: the KV cache stays at KV heads."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", q, k).to(torch.float32) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _attend_flat(q, k, v, mask, scale):
    """Flat-head attention, q/k/v all [B,S,H,hd] (train/prefill path; K/V
    expanded to H heads by the caller)."""
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * scale
    logits = torch.where(mask[:, None, :, :], logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def expand_kv(k, g: int):
    """[B,S,KV,hd] → [B,S,KV·G,hd], head h ↔ group h // G."""
    return torch.repeat_interleave(k, g, dim=2)


def gqa_attention(q, k, v, q_positions, kv_positions, *, causal: bool = True,
                  window: int | None = None, kv_valid_len=None, q_chunk: int = 0):
    """Grouped-query attention with optional banded (sliding) masking and
    chunked prefill. q [B, Sq, H, hd]; k, v [B, Skv, KV, hd] (grouped) or
    [B, Skv, H, hd] (expanded); positions int32 [B, Sq] and [B, Skv];
    ``kv_valid_len`` [B]: live cache slots per row (decode). Returns
    [B, Sq, H, hd]."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    scale = hd ** -0.5
    skv = k.shape[1]

    def mask_for(qpos):
        m = torch.ones((b, qpos.shape[1], skv), dtype=torch.bool, device=q.device)
        if causal:
            m &= qpos[:, :, None] >= kv_positions[:, None, :]
        if window is not None:
            m &= (qpos[:, :, None] - kv_positions[:, None, :]) < window
        if kv_valid_len is not None:
            live = torch.arange(skv, device=q.device)[None, :] < kv_valid_len[:, None]
            m &= live[:, None, :]
        return m

    if kv == h:
        if q_chunk and sq > q_chunk and sq % q_chunk == 0:
            outs = [
                _attend_flat(q[:, i:i + q_chunk], k, v,
                             mask_for(q_positions[:, i:i + q_chunk]), scale)
                for i in range(0, sq, q_chunk)
            ]
            return torch.cat(outs, dim=1)
        return _attend_flat(q, k, v, mask_for(q_positions), scale)

    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    out = _attend_grouped(qg, k, v, mask_for(q_positions), scale)
    return out.reshape(b, sq, h, hd)


def attend_partial(q, k, v, q_positions, kv_positions, *, window: int | None = None,
                   kv_valid_len=None):
    """Causal attention over one rank's range of key positions,
    unnormalised.

    q [B, Sq, H, hd]; k, v [B, Skv, KV, hd] (grouped, KV dividing H), the
    rank's slots; ``q_positions`` [B, Sq] and ``kv_positions`` [B, Skv]
    the global positions; the mask is ``gqa_attention``'s (causal, banded,
    and ``kv_valid_len`` [B] live positions, here compared with the global
    key position). The scores are formed as ``gqa_attention`` forms them
    (a product in the activation dtype, then float32 × scale). Returns
    ``(m, l, o)``, all float32: the running max [B, Sq, H], the exp-sum
    [B, Sq, H] and the unnormalised output [B, Sq, H, hd]. A row whose
    whole range is masked gives m = finfo.min and exact zeros in l and
    o, so it adds nothing in ``combine_partials``."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    diff = q_positions[:, :, None] - kv_positions[:, None, :]
    m = diff >= 0
    if window is not None:
        m &= diff < window
    if kv_valid_len is not None:
        m &= (kv_positions < kv_valid_len[:, None])[:, None, :]
    mask = m[:, None, None, :, :]
    qg = q.reshape(b, sq, kv, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32) * scale
    logits = torch.where(mask, logits, _NEG)
    top = logits.amax(dim=-1)  # [b, kv, g, q]
    p = torch.where(mask, torch.exp(logits - top[..., None]),
                    torch.zeros((), dtype=torch.float32, device=q.device))
    lsum = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32)).reshape(b, sq, h, hd)
    return (top.permute(0, 3, 1, 2).reshape(b, sq, h),
            lsum.permute(0, 3, 1, 2).reshape(b, sq, h), o)


def combine_partials(m, l, o, mesh, axis, dtype):
    """Every rank's ``attend_partial`` over ``axis`` made one attention
    output: a max all-reduce of ``m``, each rank's ``o`` and ``l`` rescaled
    by ``exp(m_rank − m)``, one sum all-reduce of both (packed into one
    float32 tensor: gloo sums it on any device), then ``o / l`` cast to
    ``dtype``. The sums run in another order than one softmax over every
    position, so the result is within rounding of ``gqa_attention``, not
    bitwise. Every row needs a live position on some rank (a decode step's
    own position always is)."""
    from repro_torch.sharding.collectives import all_reduce_axes

    top = all_reduce_axes(m.clone(), mesh, axis, "max")
    r = torch.exp(m - top)
    packed = torch.cat([o * r[..., None], (l * r)[..., None]], dim=-1)
    packed = all_reduce_axes(packed, mesh, axis, "sum")
    return (packed[..., :-1] / packed[..., -1:]).to(dtype)


# ----------------------------------------------------------------------- MLP

def glu_mlp(x, wi, wg, wo):
    """SwiGLU: (silu(x@wg) * (x@wi)) @ wo."""
    h = F.silu(torch.einsum("bsd,df->bsf", x, wg.to(x.dtype)))
    h = h * torch.einsum("bsd,df->bsf", x, wi.to(x.dtype))
    return torch.einsum("bsf,fd->bsd", h, wo.to(x.dtype))


# ----------------------------------------------------------------------- MoE

def _cumcount(ids):
    """Rank of each element among equal values, in stable order."""
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    idx = torch.arange(ids.shape[0], dtype=torch.int64, device=ids.device)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    out = torch.empty_like(idx)
    out[order] = idx - group_start
    return out


def moe_mlp(x, router_w, w_gate, w_in, w_out, *, top_k: int, capacity: int,
            shared=None):
    """Capacity-based top-k MoE with sort dispatch.

    x [B, S, D]; router_w [D, E]; w_* [E, D, F] / [E, F, D]. (token,
    choice) pairs are ranked per expert by a stable cumulative count and
    written into an [E·C, D] buffer; tokens past capacity are dropped
    (GShard semantics). Each token's k expert outputs are added to it in
    choice order, from zero, as one row at a time (the reference's
    scatter-add order, and deterministic on the card). Returns
    ``(y [B, S, D], aux)``, aux the load-balance term."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    t = b * s
    xf = x.reshape(t, d)

    logits = torch.einsum("td,de->te", xf, router_w.to(x.dtype)).to(torch.float32)
    gates, choices = torch.topk(logits, top_k, dim=-1)  # [t, k], descending
    gates = torch.softmax(gates, dim=-1)

    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)  # [t·k]
    exp_idx = choices.reshape(-1)
    gate = gates.reshape(-1)

    rank = _cumcount(exp_idx)
    keep = rank < capacity
    slot = torch.where(keep, exp_idx * capacity + rank, e * capacity)  # trash slot

    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[tok_idx]
    xs = buf[:-1].reshape(e, capacity, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", xs, w_gate.to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xs, w_in.to(x.dtype))
    ys = torch.einsum("ecf,efd->ecd", h, w_out.to(x.dtype))

    ys_flat = ys.reshape(e * capacity, d)
    contrib = torch.where(keep[:, None], ys_flat[torch.clamp(slot, max=e * capacity - 1)],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = (contrib * gate[:, None].to(x.dtype)).reshape(t, top_k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + contrib[:, j]

    probs = torch.softmax(logits, dim=-1)
    load = torch.mean(probs, dim=0)
    counts = torch.zeros(e, dtype=torch.int32, device=x.device).index_add_(
        0, exp_idx, torch.ones_like(exp_idx, dtype=torch.int32))  # exact in any order
    importance = counts.to(torch.float32) / (t * top_k)
    aux = e * torch.sum(load * importance)
    if shared is not None:  # shared-expert branch (DeepSeek/Kimi style)
        sw_gate, sw_in, sw_out = shared
        hs = F.silu(torch.einsum("td,df->tf", xf, sw_gate.to(x.dtype)))
        hs = hs * torch.einsum("td,df->tf", xf, sw_in.to(x.dtype))
        out = out + torch.einsum("tf,fd->td", hs, sw_out.to(x.dtype))
    return out.reshape(b, s, d), aux


# ---------------------------------------------------------- multi-device forms

def vocab_lookup(table, ids, mesh, axis, seq_axis=None):
    """``table[ids]`` of a table whose rows (vocab) are split over ``axis``
    (None: whole): each rank reads the ids in its row range, zero for the
    rest, and the partial rows are summed over ``axis`` (Megatron's
    vocab-parallel embedding). With ``seq_axis`` (sequence parallelism,
    ids [B, S]; the same axis as ``axis`` where both are split) the rows
    leave through ``scatter_seq``: the sum, then this rank's slice of the
    sequence."""
    from repro_torch.sharding.collectives import reduce_from, scatter_seq

    split = mesh is not None and axis is not None and mesh.extent(axis) > 1
    sp = mesh is not None and seq_axis is not None and mesh.extent(seq_axis) > 1
    if not split:
        rows = table[ids]
        return scatter_seq(rows, mesh, seq_axis, 1, reduce=False) if sp else rows
    v_loc = table.shape[0]
    local = ids.long() - mesh.index(axis) * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = table[local.clamp(0, v_loc - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return scatter_seq(rows, mesh, seq_axis, 1) if sp else reduce_from(rows, mesh, axis)


def moe_mlp_shmap(x, router_w, w_gate, w_in, w_out, *, top_k: int, capacity_local: int,
                  mesh, expert_axis, token_axes) -> tuple:
    """Expert-parallel MoE: one rank's part (the reference's shard_map body).

    ``x`` [B_loc, S, D] is this rank's token shard (split over
    ``token_axes``, the same on every rank of ``expert_axis``); ``router_w``
    [D, E] whole; ``w_*`` this rank's block of E/M experts ([E_loc, D, F],
    [E_loc, F, D]) along ``expert_axis`` (None: every expert here). Every
    rank routes its own tokens (top-k of the whole router), ranks the
    (token, choice) pairs its experts own by a stable cumulative count,
    keeps ``capacity_local`` a local expert, and dispatches by the inverted
    slot map (every buffer is [E_loc·C, D]). Each token's kept outputs are
    added to it in choice order, from zero (deterministic on the card; the
    reference's scatter-add leaves that order to its compiler), and one
    all-reduce of [T_loc, D] over ``expert_axis`` sums the experts' blocks.
    The load-balance aux takes the mean of ``load`` and ``imp`` over the
    token shards (on the expert axis they are the same). Returns
    ``(y [B_loc, S, D], aux)``.

    Gradients: x and the gates enter the expert-split part through
    ``copy_to`` and leave it through ``reduce_from`` (Megatron's f and g),
    so every rank of ``expert_axis`` holds the whole gradient of x and of
    the router; ``load``'s sum over the token shards passes its gradient
    back summed (``sum_shards``), for a loss that each token shard adds its
    share to."""
    from repro_torch.sharding.collectives import (
        all_reduce_axes,
        copy_to,
        reduce_from,
        sum_shards,
    )

    e_loc = w_gate.shape[0]
    e = router_w.shape[-1]
    m = mesh.index(expert_axis) if expert_axis is not None else 0
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    logits = torch.einsum("td,de->te", xf, router_w.to(x.dtype)).to(torch.float32)
    gates, choices = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(gates, dim=-1)

    tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
    exp_idx = choices.reshape(-1)
    gate = gates.reshape(-1).to(x.dtype)

    owned = (exp_idx >= m * e_loc) & (exp_idx < (m + 1) * e_loc)
    local_e = torch.where(owned, exp_idx - m * e_loc, e_loc)
    rank = _cumcount(torch.where(owned, local_e, e_loc + 1))
    keep = owned & (rank < capacity_local)
    n_slots = e_loc * capacity_local
    slot = torch.where(keep, local_e * capacity_local + rank, n_slots)

    # The inverted map: the token of every slot (t for an empty slot, whose
    # row of the extended input is zero). Only the trash slot takes
    # several writes, and it is dropped.
    token_for_slot = torch.full((n_slots + 1,), t, dtype=torch.long, device=x.device)
    token_for_slot[slot] = tok_idx
    xe = copy_to(xf, mesh, expert_axis)
    xf_ext = torch.cat([xe, torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    xs = xf_ext[token_for_slot[:-1]].reshape(e_loc, capacity_local, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", xs, w_gate.to(x.dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xs, w_in.to(x.dtype))
    ys = torch.einsum("ecf,efd->ecd", h, w_out.to(x.dtype)).reshape(n_slots, d)

    ge = copy_to(gate, mesh, expert_axis)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    contrib = torch.where(keep[:, None], ys[torch.clamp(slot, max=max(n_slots - 1, 0))], zero)
    contrib = (contrib * ge[:, None]).reshape(t, top_k, d)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        out = out + contrib[:, j]
    out = reduce_from(out, mesh, expert_axis)

    shards = mesh.extent(token_axes) if token_axes else 1
    probs = torch.softmax(logits, dim=-1)
    load = sum_shards(torch.mean(probs, dim=0), mesh, token_axes) / shards
    counts = torch.zeros(e, dtype=torch.int32, device=x.device).index_add_(
        0, exp_idx, torch.ones_like(exp_idx, dtype=torch.int32))
    imp = counts.to(torch.float32) / (t * top_k)
    if token_axes:
        imp = all_reduce_axes(imp, mesh, token_axes, "sum") / shards
    aux = e * torch.sum(load * imp)
    return out.reshape(b, s, d), aux
