#!/usr/bin/env python3
"""The full path's layout seconds, repeated, for one tree.

Runs ``repro_torch.layout`` with the full path's grid repulsion (grid 64,
window 32, rebuilt every iteration, 500 iterations, no radii, masses
degree + 1, the seeded random start) on the chip smoke's graph (685,230
nodes, ≈ 6.6 M edges) ``--reps`` times in one process on the card, after
one warm-up run, with the ``repro_torch`` of ``--tree`` (a checkout or an
unpacked ``git archive``; default: this repository), and prints one JSON
line per run: the layout's seconds (host clock around work ending in a
device synchronize) and ms per iteration. To compare two trees, run it for
each in turns in one chip call (parent, change, change, parent):

    python3 tools/full_layout_walls.py --tree build/parent --reps 3

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

# The chip smoke's graph and full-path layout (chip_smoke.py: NODES ... WINDOW).
NODES, COMMUNITIES, P_IN, P_OUT, SEED = 685_230, 200, 0.0051, 2.6e-6, 0
FULL_ITERATIONS, GRID, WINDOW = 500, 64, 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("full_layout_walls: needs a CUDA card", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import degrees

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    edges, _ = planted_partition(NODES, COMMUNITIES, P_IN, P_OUT, seed=SEED)
    edges = torch.as_tensor(edges, device="cuda")
    weights = torch.ones(edges.shape[0], device="cuda")
    mass = degrees(edges, NODES).to(torch.float32) + 1.0
    cfg = fa2.FA2Config(iterations=FULL_ITERATIONS, repulsion="grid", grid_size=GRID,
                        grid_window=WINDOW, grid_rebuild=1, use_radii=False)
    pos0 = fa2.init_positions(NODES, cfg.seed, device="cuda")
    for rep in range(args.reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos, _, its = repro_torch.layout(edges, weights, mass, NODES, cfg, pos0=pos0,
                                         device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if rep == 0:
            continue  # warm-up: kernel builds and loads, first-use costs
        print(json.dumps({"tree": str(tree), "rep": rep, "layout_s": seconds,
                          "ms_per_iteration": seconds / its * 1e3,
                          "max_abs_pos": float(pos.abs().max()), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
