#!/usr/bin/env python3
"""The main path's wall and stage seconds, repeated, for one tree.

Runs ``biggraphvis`` + ``BGVResult.render`` on the chip smoke's graph
(685,230 nodes, ≈ 6.6 M edges, chunks of 65,536) ``--reps`` times in one
process on the card, after one warm-up run, with the ``repro_torch`` of
``--tree`` (a checkout or an unpacked ``git archive``; default: this
repository), and prints one JSON line per run: the wall (host clock around
work ending in a device synchronize) and the stage seconds. To compare two
trees, run it for each in turns in one chip call (parent, change, change,
parent):

    python3 tools/main_path_walls.py --tree build/parent --reps 5

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# The chip smoke's main path (chip_smoke.py: NODES ... MAIN_CHUNK).
NODES, COMMUNITIES, P_IN, P_OUT, SEED = 685_230, 200, 0.0051, 2.6e-6, 0
ITERATIONS, MAIN_CHUNK = 100, 1 << 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("main_path_walls: needs a CUDA card", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    edges, _ = planted_partition(NODES, COMMUNITIES, P_IN, P_OUT, seed=SEED)
    cfg = repro_torch.default_config(NODES, len(edges), mode_degree(edges, NODES),
                                     iterations=ITERATIONS)
    scfg = repro_torch.StreamConfig(chunk_size=MAIN_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        png = str(Path(tmp) / "main.png")
        for rep in range(args.reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = repro_torch.biggraphvis(edges, NODES, cfg, scfg, device="cuda")
            res.render(png)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rep == 0:
                continue  # warm-up: kernel builds and loads, first-use costs
            print(json.dumps({"tree": str(tree), "rep": rep, "main_path_wall_s": wall,
                              **res.timings, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
