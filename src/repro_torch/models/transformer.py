"""LM transformer family: dense (Yi, Mistral-Large, Gemma3) and MoE
(Kimi-K2, Granite) with GQA, RoPE, SwiGLU, optional sliding-window layers
(Gemma3's 5:1 local:global), chunked prefill, and a KV-cache decode step.

The reference's ``models/transformer.py`` scans over stacked layer
parameters; here a Python loop walks the same stacked tensors. Its
activation sharding constraints have no counterpart on one card. Where a
gradient is being recorded, each layer is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's scan body is under
``checkpoint(..., nothing_saveable)``: at yi-6b's width a 4,096-token
row keeps 2.1 GB of float32 attention scores a layer otherwise.

On a ``ModelMesh`` (``forward``/``lm_loss`` with a ``Placement``, profile
"tp") each rank holds its blocks of the parameters and its rows of the
batch, and every product follows the placement ``spec_for`` gave its
weight (Megatron TP, ZeRO-3 of d_model):
* a weight dim sharded over "model" that is an output (heads, mlp,
  experts, vocab) makes the product column-parallel; its input enters
  through ``copy_to`` (f: identity, gradient summed over "model");
* a contracted dim sharded over "model" (``wo``, ``wo_mlp``, the shared
  expert's output) makes it row-parallel, followed by ``reduce_from`` (g:
  the all-reduce over "model");
* a dim sharded over other axes (d_model over ("pod", "data")) is gathered
  before use (``Placement.use``), its gradient reduced back to the block;
* the embedding is a vocab-parallel lookup, the loss a vocab-parallel cross
  entropy (max and sum over "model", the gold logit by the iota match);
* heads that ``spec_for`` leaves whole stay replicated, and the K/V heads
  (no profile maps "kv_heads") are computed whole on every rank, each rank
  attending with its heads' groups; their weights take ``copy_to``;
* MoE layers run ``layers.moe_mlp_shmap``, the capacity from the local
  token count.
Activations stay replicated over "model": the reference's
sequence-parallel activation constraints place memory and change no
arithmetic, and sequence parallelism waits for the serving slice. Each
rank's loss is its rows' share of the global mean (summed over the batch
axes by the train step), so a step on D ranks computes the reference's
sharded step.

The decode step differs from the reference's in one way, a repair: it
takes each slot's own length (``cur_len`` [B]) and an optional ``active``
mask, writes K/V only into the active slots at their own positions and
masks each slot by its own length. The reference writes every slot at one
shared length and masks all slots by it, so concurrent requests of
different lengths corrupt each other (fault R5). With a scalar
``cur_len`` and every slot active the two steps are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, cast_floats


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_padded: int  # padded to mesh divisibility
    moe: MoESpec | None = None
    sliding_window: int | None = None  # window size for local layers
    global_every: int = 0  # gemma3: every 6th layer is global (5:1)
    rope_theta: float = 10000.0
    act_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    q_chunk: int = 1024  # chunked prefill threshold/chunk


# ------------------------------------------------------------------- params

def param_specs(cfg: LMConfig) -> dict:
    nl, d, h, kv, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    specs = {
        "embed": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"), "normal", dt),
        "final_norm": ParamSpec((d,), ("embed",), "zeros", dt),
        "unembed": ParamSpec((d, cfg.vocab_padded), ("embed", "vocab"), "scaled", dt),
        "layers": {
            "attn_norm": ParamSpec((nl, d), ("layer", "embed"), "zeros", dt),
            "mlp_norm": ParamSpec((nl, d), ("layer", "embed"), "zeros", dt),
            "wq": ParamSpec((nl, d, h, hd), ("layer", "embed", "heads", "head_dim"), "scaled", dt),
            "wk": ParamSpec((nl, d, kv, hd), ("layer", "embed", "kv_heads", "head_dim"), "scaled", dt),
            "wv": ParamSpec((nl, d, kv, hd), ("layer", "embed", "kv_heads", "head_dim"), "scaled", dt),
            "wo": ParamSpec((nl, h, hd, d), ("layer", "heads", "head_dim", "embed"), "scaled", dt),
        },
    }
    lyr = specs["layers"]
    if cfg.moe is None:
        lyr["wi"] = ParamSpec((nl, d, cfg.d_ff), ("layer", "embed", "mlp"), "scaled", dt)
        lyr["wg"] = ParamSpec((nl, d, cfg.d_ff), ("layer", "embed", "mlp"), "scaled", dt)
        lyr["wo_mlp"] = ParamSpec((nl, cfg.d_ff, d), ("layer", "mlp", "embed"), "scaled", dt)
    else:
        m = cfg.moe
        lyr["router"] = ParamSpec((nl, d, m.n_experts), ("layer", "embed", "expert"), "scaled", dt)
        lyr["we_g"] = ParamSpec((nl, m.n_experts, d, m.d_ff_expert), ("layer", "expert", "embed", "mlp"), "scaled", dt)
        lyr["we_i"] = ParamSpec((nl, m.n_experts, d, m.d_ff_expert), ("layer", "expert", "embed", "mlp"), "scaled", dt)
        lyr["we_o"] = ParamSpec((nl, m.n_experts, m.d_ff_expert, d), ("layer", "expert", "mlp", "embed"), "scaled", dt)
        if m.n_shared:
            f_sh = m.d_ff_expert * m.n_shared
            lyr["ws_g"] = ParamSpec((nl, d, f_sh), ("layer", "embed", "mlp"), "scaled", dt)
            lyr["ws_i"] = ParamSpec((nl, d, f_sh), ("layer", "embed", "mlp"), "scaled", dt)
            lyr["ws_o"] = ParamSpec((nl, f_sh, d), ("layer", "mlp", "embed"), "scaled", dt)
    return specs


def _is_global_layer(cfg: LMConfig, idx: int) -> bool:
    """Gemma3 pattern: layers global_every-1, 2·global_every-1, … are global."""
    if cfg.sliding_window is None or cfg.global_every == 0:
        return True
    return (idx + 1) % cfg.global_every == 0


def _layer_params(layers: dict, i: int) -> dict:
    return {k: v[i] for k, v in layers.items()}


# ------------------------------------------------------------------ forward

def _layer(cfg: LMConfig, x, lp, layer_idx: int, positions, kv_positions=None,
           kv_cache=None, cur_len=None, active=None, capacity=None, place=None):
    """One transformer block. With ``kv_cache`` (decode) the new K/V are
    written into the cache in place, at each active slot's ``cur_len``
    (``active`` [B] bool), and attention runs over the cache; else
    self-attention over x. The write reads the slot's old line back for
    the inactive slots, so nothing waits on the device. ``place`` (a
    ``Placement`` whose ``specs`` are the layer's) runs the rank's part."""
    if place is not None:
        return _layer_tp(cfg, x, lp, layer_idx, positions, capacity, place)
    b, s, d = x.shape
    rms = L.rms_norm(x, lp["attn_norm"])
    q = torch.einsum("bsd,dhk->bshk", rms, lp["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", rms, lp["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", rms, lp["wv"].to(x.dtype))
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        ck, cv = kv_cache  # [B, S_max, KV, hd], stays at KV heads
        rows = torch.arange(b, device=x.device)
        keep = active[:, None, None]
        for j in range(s):
            at = (rows, torch.where(active, cur_len.long() + j, 0))
            ck[at] = torch.where(keep, k[:, j].to(ck.dtype), ck[at])
            cv[at] = torch.where(keep, v[:, j].to(cv.dtype), cv[at])
        k_att, v_att = ck, cv
        kv_pos = kv_positions
        valid = cur_len + s
    else:
        g = cfg.n_heads // cfg.n_kv_heads
        k_att, v_att = L.expand_kv(k, g), L.expand_kv(v, g)
        kv_pos = positions
        valid = None

    window = None
    if cfg.sliding_window is not None:
        window = 2**30 if _is_global_layer(cfg, layer_idx) else cfg.sliding_window

    out = L.gqa_attention(
        q, k_att.to(x.dtype), v_att.to(x.dtype), positions, kv_pos,
        causal=True, window=window, kv_valid_len=valid, q_chunk=cfg.q_chunk,
    )
    x = x + torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(x.dtype))

    rms = L.rms_norm(x, lp["mlp_norm"])
    aux = 0.0
    if cfg.moe is None:
        y = L.glu_mlp(rms, lp["wi"], lp["wg"], lp["wo_mlp"])
    else:
        m = cfg.moe
        shared = (lp["ws_g"], lp["ws_i"], lp["ws_o"]) if m.n_shared else None
        y, aux = L.moe_mlp(rms, lp["router"], lp["we_g"], lp["we_i"], lp["we_o"],
                           top_k=m.top_k, capacity=capacity, shared=shared)
    return x + y, aux


def _window(cfg: LMConfig, layer_idx: int):
    if cfg.sliding_window is None:
        return None
    return 2**30 if _is_global_layer(cfg, layer_idx) else cfg.sliding_window


def _layer_tp(cfg: LMConfig, x, lp, layer_idx: int, positions, capacity, place):
    """One block on a rank's parameter blocks (the module docstring's
    rules); train and prefill."""
    from repro_torch.sharding.collectives import copy_to, reduce_from

    mesh, tp, ls = place.mesh, place.tp_axis, place.specs

    def w(name):
        return place.use(lp[name], ls[name]).to(x.dtype)

    heads_tp = place.tp(ls["wq"], 1)
    if heads_tp != place.tp(ls["wo"], 0):
        raise NotImplementedError("wq and wo split their heads differently")
    rms = L.rms_norm(x, w("attn_norm"))
    xa = copy_to(rms, mesh, tp) if heads_tp else rms
    wk, wv = w("wk"), w("wv")
    if heads_tp:
        wk, wv = copy_to(wk, mesh, tp), copy_to(wv, mesh, tp)
    q = torch.einsum("bsd,dhk->bshk", xa, w("wq"))
    k = torch.einsum("bsd,dhk->bshk", xa, wk)
    v = torch.einsum("bsd,dhk->bshk", xa, wv)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    g = cfg.n_heads // cfg.n_kv_heads
    k_att, v_att = L.expand_kv(k, g), L.expand_kv(v, g)
    if heads_tp:  # this rank's heads and their K/V groups
        h_loc = q.shape[2]
        h0 = mesh.index(tp) * h_loc
        k_att, v_att = k_att[:, :, h0:h0 + h_loc], v_att[:, :, h0:h0 + h_loc]
    out = L.gqa_attention(q, k_att, v_att, positions, positions, causal=True,
                          window=_window(cfg, layer_idx), q_chunk=cfg.q_chunk)
    y = torch.einsum("bshk,hkd->bsd", out, w("wo"))
    x = x + (reduce_from(y, mesh, tp) if heads_tp else y)

    rms = L.rms_norm(x, w("mlp_norm"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is None:
        y = _glu_tp(rms, w("wi"), w("wg"), w("wo_mlp"), place.tp(ls["wi"], 1), mesh, tp)
    else:
        m = cfg.moe
        expert_tp = place.tp(ls["we_g"], 0)
        y, aux = L.moe_mlp_shmap(
            rms, place.use(lp["router"], ls["router"], whole=True), w("we_g"), w("we_i"),
            w("we_o"), top_k=m.top_k, capacity_local=capacity, mesh=mesh,
            expert_axis=tp if expert_tp else None, token_axes=place.batch_axes)
        if m.n_shared:
            y = y + _glu_tp(rms, w("ws_i"), w("ws_g"), w("ws_o"), place.tp(ls["ws_g"], 1),
                            mesh, tp)
    return x + y, aux


def _glu_tp(x, wi, wg, wo, split: bool, mesh, tp):
    """SwiGLU with its hidden dim split over ``tp`` (column, then row
    parallel) or whole."""
    from repro_torch.sharding.collectives import copy_to, reduce_from

    if not split:
        return L.glu_mlp(x, wi, wg, wo)
    return reduce_from(L.glu_mlp(copy_to(x, mesh, tp), wi, wg, wo), mesh, tp)


def _layer_place(place, specs_layers):
    """The placement of one layer: the stacked specs without the layer dim
    (never sharded: no profile maps "layer")."""
    from dataclasses import replace as _replace

    from repro_torch.sharding.rules import P

    return _replace(place, specs={k: P(*v[1:]) for k, v in specs_layers.items()})


def _moe_capacity(cfg: LMConfig, tokens: int) -> int | None:
    """Per-expert capacity for ``tokens`` tokens."""
    if cfg.moe is None:
        return None
    m = cfg.moe
    cap = int(m.top_k * tokens / m.n_experts * m.capacity_factor)
    return max(8, (cap + 7) // 8 * 8)


def forward(cfg: LMConfig, params, tokens, positions, place=None):
    """tokens [B, S] → (logits [B, S, vocab_padded], aux). Train and
    prefill. Where a gradient is being recorded, each layer keeps only its
    input for the backward pass and is run again there. With ``place`` the
    rank's part: its rows of tokens, its blocks of ``params``; the logits
    are this rank's vocab shard."""
    lplace = None
    if place is None:
        x = params["embed"].to(cfg.act_dtype)[tokens]
    else:
        sp = place.specs
        emb = place.use(params["embed"], sp["embed"]).to(cfg.act_dtype)
        x = L.vocab_lookup(emb, tokens, place.mesh,
                           place.tp_axis if place.tp(sp["embed"], 0) else None)
        lplace = _layer_place(place, sp["layers"])
    capacity = _moe_capacity(cfg, tokens.shape[0] * tokens.shape[1])
    # Cast once, before the loop (the reference casts before its scan), and
    # split each stacked tensor into its layers with one unbind: its
    # backward stacks the layers' gradients once, where indexing layer i
    # would give each layer a zero-filled gradient of the whole stack.
    layers = {k: v.unbind(0) for k, v in cast_floats(params["layers"], cfg.act_dtype).items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer_params(layers, i)
        if remat:
            x, a = checkpoint(_layer, cfg, x, lp, i, positions, capacity=capacity,
                              place=lplace, use_reentrant=False)
        else:
            x, a = _layer(cfg, x, lp, i, positions, capacity=capacity, place=lplace)
        aux = aux + a
    if place is None:
        x = L.rms_norm(x, params["final_norm"])
        return torch.einsum("bsd,dv->bsv", x, params["unembed"].to(x.dtype)), aux
    from repro_torch.sharding.collectives import copy_to

    x = L.rms_norm(x, place.use(params["final_norm"], sp["final_norm"]))
    if place.tp(sp["unembed"], 1):
        x = copy_to(x, place.mesh, place.tp_axis)
    un = place.use(params["unembed"], sp["unembed"])
    return torch.einsum("bsd,dv->bsv", x, un.to(x.dtype)), aux


def _lm_loss_tp(cfg: LMConfig, params, batch, place):
    """The rank's share of ``lm_loss``: its rows' masked nll over the global
    mask count, plus 0.01 × aux over the number of batch shards, so that
    the ranks of the batch axes sum to the loss; the cross entropy over
    the vocab shards (max and sums over "model")."""
    from repro_torch.sharding.collectives import all_reduce_axes, reduce_from

    mesh, tp = place.mesh, place.tp_axis
    tokens, loss_mask = batch["tokens"], batch["loss_mask"]
    b, s = tokens.shape
    logits, aux = forward(cfg, params, tokens, _positions(b, s, tokens.device), place)
    logits = logits.to(torch.float32)
    v_loc = logits.shape[-1]
    split = place.tp(place.specs["unembed"], 1)
    v0 = mesh.index(tp) * v_loc if split else 0
    vidx = v0 + torch.arange(v_loc, device=logits.device)
    logits = torch.where((vidx < cfg.vocab)[None, None, :], logits, L._NEG)
    targets = torch.roll(tokens, -1, dims=1)
    top = logits.detach().amax(dim=-1)
    if split:
        top = all_reduce_axes(top, mesh, tp, "max")
    total = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
    gold = torch.sum(torch.where(vidx[None, None, :] == targets[..., None], logits, 0.0), dim=-1)
    if split:
        total, gold = reduce_from(total, mesh, tp), reduce_from(gold, mesh, tp)
    nll = (top + torch.log(total) - gold) * loss_mask
    count = all_reduce_axes(torch.sum(loss_mask).detach().clone(), mesh, place.batch_axes)
    shards = mesh.extent(place.batch_axes)
    return torch.sum(nll) / torch.clamp(count, min=1.0) + 0.01 * aux / shards


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def lm_loss(cfg: LMConfig, params, batch, place=None):
    """Causal next-token cross-entropy with vocab padding masked out, plus
    0.01 × the MoE load-balance term. With ``place``, the rank's share of
    it (``_lm_loss_tp``)."""
    if place is not None:
        return _lm_loss_tp(cfg, params, batch, place)
    tokens, loss_mask = batch["tokens"], batch["loss_mask"]
    b, s = tokens.shape
    logits, aux = forward(cfg, params, tokens, _positions(b, s, tokens.device))
    logits = logits.to(torch.float32)
    vmask = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
    logits = torch.where(vmask[None, None, :], logits, L._NEG)
    targets = torch.roll(tokens, -1, dims=1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - gold) * loss_mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(loss_mask), min=1.0)
    return loss + 0.01 * aux


def make_prefill(cfg: LMConfig):
    """tokens [B, S] → logits (inference prefill, no loss)."""

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        params_c = cast_floats(params, cfg.act_dtype)
        logits, _ = forward(cfg, params_c, tokens, _positions(b, s, tokens.device))
        return logits

    return prefill


def make_decode_step(cfg: LMConfig):
    """One new token against an [L, B, S_max, KV, hd] KV cache.

    ``batch``: ``tokens`` [B, 1]; ``cur_len``, a scalar (every slot at one
    length) or [B] int32 (each slot's own); ``active`` [B] bool, optional
    (default: every slot), the slots whose K/V are written. Each slot
    needs ``cur_len + 1 ≤ S_max``. Returns ``(logits [B, 1, vocab_padded],
    cache)``; the cache is updated in place."""

    def decode_step(params, cache, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        dev = tokens.device
        cur_len = torch.as_tensor(batch["cur_len"], dtype=torch.int32, device=dev)
        cur_len = cur_len.expand(b) if cur_len.dim() == 0 else cur_len
        active = batch.get("active")
        if active is None:
            active = torch.ones(b, dtype=torch.bool, device=dev)
        s_max = cache["k"].shape[2]
        positions = cur_len[:, None] + torch.arange(s, dtype=torch.int32, device=dev)
        kv_positions = _positions(b, s_max, dev)
        params_c = cast_floats(params, cfg.act_dtype)
        x = params_c["embed"][tokens]
        capacity = _moe_capacity(cfg, b * s)
        for i in range(cfg.n_layers):
            x, _ = _layer(cfg, x, _layer_params(params_c["layers"], i), i, positions,
                          kv_positions=kv_positions,
                          kv_cache=(cache["k"][i], cache["v"][i]),
                          cur_len=cur_len, active=active, capacity=capacity)
        x = L.rms_norm(x, params_c["final_norm"])
        logits = torch.einsum("bsd,dv->bsv", x, params_c["unembed"].to(x.dtype))
        return logits, cache

    return decode_step


def init_kv_cache(cfg: LMConfig, batch: int, s_max: int, device) -> dict:
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.act_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.act_dtype, device=device)}


def abstract_kv_cache(cfg: LMConfig, batch: int, s_max: int) -> dict:
    return init_kv_cache(cfg, batch, s_max, "meta")
