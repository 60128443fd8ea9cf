"""Plain PyTorch versions for sorted-merge-and-combine (superedge
aggregation), and the merge-path ranks that feed kernel K1.

Merges two (a, b)-sorted deduplicated superedge runs — the persistent
aggregation state [cap] and a locally deduped chunk [C] — into one sorted
deduplicated run of the state's capacity, summing the weights of pairs
present in both. Output ranks come from binary searches
(``torch.searchsorted``) because both runs are already sorted; the rows
then land in their slots (``merge_place_ref`` here, kernel K1 on the
card).

Pairs compare as packed keys ``a·s_cap + b``: valid pairs satisfy
``a < b < s_cap ≤ 2¹⁶`` so the packing is collision-free and
order-preserving; padded ``(s_cap, s_cap)`` slots map to the sentinel
``0xFFFFFFFF`` and sort last. The keys are int64 holding uint32 values:
torch's uint32 lacks add, shift, mod and searchsorted on the CPU.
"""
from __future__ import annotations

import torch

SENTINEL = 0xFFFFFFFF
MAX_S_CAP = 1 << 16  # packing needs a, b < s_cap ≤ 2^16 to fit 32 bits


def pack_keys(a: torch.Tensor, b: torch.Tensor, s_cap: int) -> torch.Tensor:
    """(a, b) int32 pairs → order-preserving int64 keys (invalid → sentinel)."""
    if s_cap > MAX_S_CAP:
        raise ValueError(
            f"packed pair keys require s_cap ≤ {MAX_S_CAP}, got {s_cap}; "
            "use agg_backend='lexsort' beyond that"
        )
    key = (a.long() * s_cap + b.long()) & 0xFFFFFFFF
    return torch.where(a < s_cap, key, SENTINEL)


def unpack_keys(key: torch.Tensor, s_cap: int):
    """int64 keys → (a, b) int32 pairs; sentinel → the (s_cap, s_cap) pad."""
    pad = key == SENTINEL
    a = torch.where(pad, s_cap, key // s_cap).to(torch.int32)
    b = torch.where(pad, s_cap, key % s_cap).to(torch.int32)
    return a, b


def merge_positions(sk: torch.Tensor, ck: torch.Tensor):
    """Merge-path ranks for the union of two sorted unique key runs.

    ``sk`` [cap] / ``ck`` [C] are keys, each sorted ascending with every
    valid key unique and sentinel padding last. Returns ``(pos_state [cap],
    pos_chunk [C], new_chunk [C])``: the rank of each row's key in the
    sorted union. Chunk keys already present in the state get their state
    partner's rank (so a scatter-add combines the weights) and
    ``new_chunk`` False; sentinel rows rank at ``cap + C``, past any
    capacity. Ranks are int32.
    """
    cap, c = sk.shape[0], ck.shape[0]
    valid_s = sk != SENTINEL
    valid_c = ck != SENTINEL
    ins_s = torch.searchsorted(sk, ck, side="left")  # [C] ∈ [0, cap]
    partner = ins_s.clamp(max=cap - 1)
    dup = valid_c & (sk[partner] == ck)
    dup_cum = torch.cat(
        [torch.zeros(1, dtype=torch.long, device=sk.device), torch.cumsum(dup, 0)]
    )
    ins_c = torch.searchsorted(ck, sk, side="left")  # [cap] ∈ [0, C]
    drop = cap + c
    pos_s = torch.arange(cap, device=sk.device) + ins_c - dup_cum[ins_c]
    pos_s = torch.where(valid_s, pos_s, drop)
    new_c = valid_c & ~dup
    arange_c = torch.arange(c, device=sk.device)
    pos_new = ins_s + arange_c - dup_cum[arange_c]
    pos_c = torch.where(new_c, pos_new, torch.where(dup, pos_s[partner], drop))
    return pos_s.to(torch.int32), pos_c.to(torch.int32), new_c


def scatter_combine_ref(pos, a, b, w, cap: int):
    """Plain version of kernel K1: place rows at their output positions.

    Rows with ``0 ≤ pos < cap`` combine into slot ``pos``: keys by max,
    weights by +; other rows are dropped. Unhit slots return keys -1 and
    weight 0. ``pos``/``a``/``b`` [N] int32, ``w`` [N] float32.
    """
    keep = (pos >= 0) & (pos < cap)
    idx = torch.where(keep, pos, cap).long()  # slot cap is scratch, cut off
    oa = torch.full((cap + 1,), -1, dtype=torch.int32, device=pos.device)
    ob = torch.full((cap + 1,), -1, dtype=torch.int32, device=pos.device)
    ow = torch.zeros(cap + 1, dtype=torch.float32, device=pos.device)
    oa.scatter_reduce_(0, idx, a, "amax", include_self=True)
    ob.scatter_reduce_(0, idx, b, "amax", include_self=True)
    ow.index_add_(0, idx, w)
    return oa[:cap], ob[:cap], ow[:cap]


def merge_place_ref(pos_s, sa, sb, sw, pos_c, ca, cb, cw, cap: int):
    """Plain version of kernel K1's ``merge_place``: the rows of the state
    run [ns] and the chunk run [nc] at their ranks, combined by
    ``scatter_combine_ref`` over the concatenated runs (state rows first).

    The kernel relies on what ``merge_positions`` guarantees: within each
    run ranks are nondecreasing, strictly increasing below ``cap``.
    """
    return scatter_combine_ref(
        torch.cat([pos_s, pos_c]), torch.cat([sa, ca]), torch.cat([sb, cb]),
        torch.cat([sw, cw]), cap,
    )


def merge_combine_ref(sa, sb, sw, ca, cb, cw, s_cap: int, place=merge_place_ref):
    """Merge a sorted deduped chunk run into the sorted state run.

    ``sa``/``sb``/``sw`` [cap] and ``ca``/``cb``/``cw`` [C] are int32 pairs
    and float32 weights, each run sorted by (a, b) with (s_cap, s_cap, 0)
    padding last. Returns ``(oa [cap], ob [cap], ow [cap], n)`` with the
    union's lexicographically smallest ``cap`` pairs (overflow truncates
    the sorted tail, same contract as the lexsort path) and ``n`` the count
    of unique valid pairs in the union (may exceed ``cap``). ``place``
    puts the ranked rows in their slots: the plain version here, kernel K1
    in ``ops.merge_combine``.
    """
    cap = sa.shape[0]
    sk = pack_keys(sa, sb, s_cap)
    ck = pack_keys(ca, cb, s_cap)
    pos_s, pos_c, new_c = merge_positions(sk, ck)
    oa, ob, ow = place(pos_s, sa, sb, sw, pos_c, ca, cb, cw, cap)
    oa = torch.where(oa < 0, s_cap, oa)
    ob = torch.where(ob < 0, s_cap, ob)
    n = ((sk != SENTINEL).sum() + new_c.sum()).to(torch.int32)
    return oa, ob, ow, n
