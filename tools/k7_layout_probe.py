#!/usr/bin/env python3
"""K7's fused attraction (``attraction_sum``) under several group settings
of the segment layout (``kernels/segment/ops.py`` GROUP_ROWS and
SPLIT_ROWS: how the narrow kernel's warps split blocks of 32 segments),
on synthetic inputs at the paths' shapes: the full path's 685,230 nodes
and 6.6 M edges (destinations uniform, or within blocks of 3,426 nodes as
a planted partition's are), and the main path's 16,384 supernodes and
262,144 superedge slots (half padding; one hub of 2,073 edges; or sources
skewed towards low ids, so blocks of long segments follow each other).
Each setting is held bitwise against the pre-change composition and timed
with CUDA events; prints one JSON line per input, each setting's
``[ms, bitwise, groups used]``.

    python3 tools/k7_layout_probe.py

Needs a CUDA card; run from the repository root.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name → (nodes, edges, edges of node 3 (a hub), padded share, destination
# block, sources skewed)
CASES = {"full_blocks": (685_230, 6_594_164, 0, 0.0, 3426, False),
         "full_random": (685_230, 6_594_164, 0, 0.0, 0, False),
         "main_hub2073": (16_384, 262_144, 2073, 0.5, 0, False),
         "main_nohub": (16_384, 262_144, 0, 0.5, 0, False),
         "main_skew": (16_384, 262_144, 0, 0.0, 0, True),
         "main_skew_half": (16_384, 131_072, 0, 0.0, 0, True)}
# (GROUP_ROWS, SPLIT_ROWS); 10**9: blocks never split.
SETTINGS = [(256, 2048), (512, 2048), (256, 1024), (128, 1024), (256, 4096), (256, 10**9)]


def inputs(torch, n, e, hub, trash, block, skew):
    g = torch.Generator(device="cuda").manual_seed(1)
    edges = torch.randint(0, n, (e, 2), generator=g, device="cuda", dtype=torch.int32)
    if skew:
        edges[:, 0] = (n * torch.rand(e, generator=g, device="cuda") ** 3).to(torch.int32)
    if block:
        near = (edges[:, 0] // block) * block + torch.randint(
            0, block, (e,), generator=g, device="cuda", dtype=torch.int32)
        edges[:, 1] = near.clamp(max=n - 1)
    if hub:
        edges[:hub, 0] = 3
    if trash:
        edges[int(e * (1 - trash)):] = n
    w = torch.ones(e, device="cuda")
    pos = torch.rand((n, 2), generator=g, device="cuda") * 2000 - 1000
    return edges, w, pos


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k7_layout_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.segment import ops as seg_ops

    resolve_device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    build.build(("segment_sum",))
    for name, args in CASES.items():
        edges, w, pos = inputs(torch, *args)
        row, want = {}, None
        for gr, sp in SETTINGS:
            seg_ops.GROUP_ROWS, seg_ops.SPLIT_ROWS = gr, sp
            dst, w2, lay = fa2._attraction_edge_layout(edges, w, pos.shape[0])
            got = seg_ops.attraction_sum(pos, dst, w2, lay)
            if want is None:
                want = cs.attraction_old(torch, pos, dst, w2, lay.offsets)[0]()
            ms = cs.cuda_ms(torch, lambda: seg_ops.attraction_sum(pos, dst, w2, lay), 20)
            row[f"{gr}/{sp}"] = (round(ms, 5), cs.bits_equal(torch, got, want),
                                 int((lay.groups < pos.shape[0]).sum()))
        print(name, json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
