"""SASRec (Kang & McAuley 2018): self-attentive sequential recommendation.

An item-embedding table → causal one-head self-attention over the user's
last S interactions → next-item scores against the same table. Steps per
shape cell:
  serve_p99/bulk  → ``make_serve_step`` (score every item for the last position)
  retrieval_cand  → ``make_retrieval_step`` (1 user × C candidate dot scores)
  train_batch     → ``sasrec_loss`` (``train.make_train_step`` takes its
                    gradient)

On a ``ModelMesh`` (``encode``/``sasrec_loss`` with a ``Placement``, profile
"recsys") the item table's vocab dim is split over "model" and every
lookup of it is vocab-parallel (``layers.vocab_lookup``); everything else
is replicated, and the batch rows are split over the data axes, each rank's
loss its rows' share of the global mean.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec


@dataclass(frozen=True)
class SASRecConfig:
    name: str
    n_items: int
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    act_dtype: Any = torch.float32


def param_specs(cfg: SASRecConfig) -> dict:
    nl, d = cfg.n_blocks, cfg.embed_dim
    dt = torch.float32
    hd = d // cfg.n_heads
    return {
        # item 0 is the padding item (classic SASRec convention)
        "item_embed": ParamSpec((cfg.n_items, d), ("vocab", "embed"), "normal", dt),
        "pos_embed": ParamSpec((cfg.seq_len, d), (None, "embed"), "normal", dt),
        "final_norm": ParamSpec((d,), ("embed",), "zeros", dt),
        "layers": {
            "attn_norm": ParamSpec((nl, d), ("layer", "embed"), "zeros", dt),
            "wq": ParamSpec((nl, d, cfg.n_heads, hd), ("layer", "embed", "heads", "head_dim"), "scaled", dt),
            "wk": ParamSpec((nl, d, cfg.n_heads, hd), ("layer", "embed", "heads", "head_dim"), "scaled", dt),
            "wv": ParamSpec((nl, d, cfg.n_heads, hd), ("layer", "embed", "heads", "head_dim"), "scaled", dt),
            "wo": ParamSpec((nl, cfg.n_heads, hd, d), ("layer", "heads", "head_dim", "embed"), "scaled", dt),
            "ffn_norm": ParamSpec((nl, d), ("layer", "embed"), "zeros", dt),
            "w1": ParamSpec((nl, d, d), ("layer", "embed", "mlp"), "scaled", dt),
            "b1": ParamSpec((nl, d), ("layer", "mlp"), "zeros", dt),
            "w2": ParamSpec((nl, d, d), ("layer", "mlp", "embed"), "scaled", dt),
            "b2": ParamSpec((nl, d), ("layer", "embed"), "zeros", dt),
        },
    }


def _items(cfg, params, ids, place):
    """Rows of the item table for ``ids`` (vocab-parallel with ``place``)."""
    table = params["item_embed"].to(cfg.act_dtype)
    if place is None:
        return table[ids]
    split = place.tp(place.specs["item_embed"], 0)
    return L.vocab_lookup(table, ids, place.mesh, place.tp_axis if split else None)


def encode(cfg: SASRecConfig, params, seq, place=None):
    """seq [B, S] item ids (0 = pad) → user states [B, S, D]."""
    b, s = seq.shape
    x = _items(cfg, params, seq, place) * (cfg.embed_dim ** 0.5)
    x = x + params["pos_embed"].to(cfg.act_dtype)[None, :s]
    x = torch.where((seq > 0)[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    positions = torch.arange(s, dtype=torch.int32, device=seq.device)[None].expand(b, s)
    layers = params["layers"]
    for i in range(cfg.n_blocks):
        lp = {k: v[i] for k, v in layers.items()}
        hn = L.rms_norm(x, lp["attn_norm"])
        q = torch.einsum("bsd,dhk->bshk", hn, lp["wq"].to(x.dtype))
        k = torch.einsum("bsd,dhk->bshk", hn, lp["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", hn, lp["wv"].to(x.dtype))
        att = L.gqa_attention(q, k, v, positions, positions, causal=True)
        x = x + torch.einsum("bshk,hkd->bsd", att, lp["wo"].to(x.dtype))
        hn = L.rms_norm(x, lp["ffn_norm"])
        y = F.relu(torch.einsum("bsd,df->bsf", hn, lp["w1"].to(x.dtype)) + lp["b1"].to(x.dtype))
        y = torch.einsum("bsf,fd->bsd", y, lp["w2"].to(x.dtype)) + lp["b2"].to(x.dtype)
        x = x + y
    return L.rms_norm(x, params["final_norm"])


def sasrec_loss(cfg: SASRecConfig, params, batch, place=None):
    """Paper objective: BCE on (h_t · e_pos) vs (h_t · e_neg) per position."""
    seq, pos, neg = batch["seq"], batch["pos"], batch["neg"]  # [B, S] each
    h = encode(cfg, params, seq, place)
    sp = torch.sum(h * _items(cfg, params, pos, place).to(h.dtype), -1).to(torch.float32)
    sn = torch.sum(h * _items(cfg, params, neg, place).to(h.dtype), -1).to(torch.float32)
    mask = (pos > 0).to(torch.float32)
    loss = -(F.logsigmoid(sp) + F.logsigmoid(-sn)) * mask
    count = torch.sum(mask)
    if place is not None:  # the rank's rows' share of the global mean
        from repro_torch.sharding.collectives import all_reduce_axes

        count = all_reduce_axes(count.detach().clone(), place.mesh, place.batch_axes)
    return torch.sum(loss) / torch.clamp(count, min=1.0)


def make_serve_step(cfg: SASRecConfig):
    """seq [B, S] → scores [B, n_items] for the next interaction."""

    def serve_step(params, batch):
        h = encode(cfg, params, batch["seq"])[:, -1]  # [B, D]
        return torch.einsum("bd,vd->bv", h, params["item_embed"].to(h.dtype))

    return serve_step


def make_retrieval_step(cfg: SASRecConfig):
    """One user sequence × [C] candidate ids → [C] scores (one batched
    product, not a loop)."""

    def retrieval_step(params, batch):
        h = encode(cfg, params, batch["seq"])[:, -1]  # [1, D]
        cand = params["item_embed"].to(h.dtype)[batch["candidates"]]  # [C, D]
        return torch.einsum("bd,cd->bc", h, cand)[0]

    return retrieval_step
