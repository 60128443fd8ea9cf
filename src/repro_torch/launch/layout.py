"""BigGraphVis CLI — the paper's end-user command.

    PYTHONPATH=src python -m repro_torch.launch.layout --edges graph.txt \
        --out layout.svg [--rounds 4] [--iterations 100] [--threshold 0]

``--edges``: whitespace-separated "src dst" lines (SNAP format; '#'
comments ignored) or ``synthetic:<n>:<communities>`` for a generated
planted-partition graph. Writes the supergraph SVG + a CSV of
(community, size, x, y, color_group). Runs on CUDA unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.graph.generators import planted_partition
from repro_torch.obs.cli import add_obs_args, obs_session


def load_edges(spec: str) -> tuple[np.ndarray, int]:
    if spec.startswith("synthetic:"):
        _, n, k = spec.split(":")
        edges, _ = planted_partition(int(n), int(k), 0.15, 0.001, seed=0)
        return edges, int(n)
    rows = []
    with open(spec) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            a, b, *_ = line.split()
            rows.append((int(a), int(b)))
    edges = np.asarray(rows, dtype=np.int64)
    # compact node ids (SNAP ids are sparse)
    uniq, inv = np.unique(edges.ravel(), return_inverse=True)
    edges = inv.reshape(-1, 2).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    return edges, len(uniq)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", required=True)
    ap.add_argument("--out", default="biggraphvis.svg")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--threshold", type=int, default=0, help="0 = mode degree (paper)")
    ap.add_argument("--s-cap", type=int, default=65536)
    ap.add_argument("--repulsion", default="exact",
                    choices=("exact", "grid", "grid_pallas", "grid_dense"),
                    help="FA2 repulsion backend: exact n² (K2) for "
                         "supergraphs, the tiled grid (K5–K7) for full-graph "
                         "scale; grid_pallas is grid")
    ap.add_argument("--grid-size", type=int, default=64,
                    help="G for the grid backends (G×G cells)")
    ap.add_argument("--grid-window", type=int, default=32,
                    help="near-field band half-width of grid repulsion")
    ap.add_argument("--grid-rebuild", type=int, default=1,
                    help="re-bin/re-sort grid cells every k iterations "
                         "(1 = every iteration, exact semantics)")
    ap.add_argument("--stop-tolerance", type=float, default=0.0,
                    help="adaptive stop: freeze the layout once global "
                         "swing <= tol * traction (0 = fixed iterations)")
    ap.add_argument("--min-iterations", type=int, default=0,
                    help="never stop the layout before this many iterations")
    ap.add_argument("--init", default="random",
                    choices=("random", "degree", "bfs"),
                    help="FA2 initial positions: uniform random, degree-"
                         "ranked sunflower spiral, or BFS hop-distance rings")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    with obs_session(args):
        _run(args)


def _run(args) -> None:
    from repro_torch.core.coloring import write_svg
    from repro_torch.core.pipeline import biggraphvis, default_config
    from repro_torch.device import resolve_device
    from repro_torch.graph.utils import mode_degree

    device = resolve_device(args.device)
    edges, n = load_edges(args.edges)
    delta = args.threshold or mode_degree(edges, n)
    print(f"graph: {n} nodes, {len(edges)} edges, δ={delta}", file=sys.stderr)

    cfg = default_config(n, len(edges), delta, rounds=args.rounds,
                         iterations=args.iterations,
                         s_cap=min(args.s_cap, n),
                         repulsion=args.repulsion, grid_size=args.grid_size,
                         grid_window=args.grid_window,
                         grid_rebuild=args.grid_rebuild,
                         stop_tolerance=args.stop_tolerance,
                         min_iterations=args.min_iterations,
                         init=args.init)
    t0 = time.perf_counter()
    res = biggraphvis(edges, n, cfg, device=device)
    print(f"BigGraphVis: {res.n_supernodes} supernodes / {res.n_superedges} "
          f"superedges, modularity {res.modularity:.3f}, "
          f"layout ran {res.timings['layout_iterations']}/"
          f"{cfg.layout.iterations} iterations, "
          f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)

    live = res.sizes > 0
    # write_svg delegates >max_nodes inputs to the rasterizer as a .png —
    # report the path it actually wrote.
    drawn = write_svg(args.out, res.positions[live],
                      np.sqrt(np.maximum(res.sizes[live], 1.0)),
                      res.groups[live], device=device)
    csv = args.out.rsplit(".", 1)[0] + ".csv"
    with open(csv, "w") as f:
        f.write("community,size,x,y,color_group\n")
        for i in np.nonzero(live)[0]:
            f.write(f"{i},{res.sizes[i]:.0f},{res.positions[i,0]:.2f},"
                    f"{res.positions[i,1]:.2f},{res.groups[i]}\n")
    print(f"wrote {drawn} + {csv}", file=sys.stderr)


if __name__ == "__main__":
    main()
