"""Quickstart on PyTorch/CUDA: BigGraphVis end to end on a synthetic
community graph, with the port (``src/repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions

Generates a planted-partition graph, runs the paper pipeline (streaming
SCoDA → count-min-sketch sizing → supergraph → ForceAtlas2 → streamed
rasterization), prints the summary, and writes supergraph_torch.png /
.svg and full_colored_torch.png / .svg next to this script. The kernels
build with ``nvcc`` at first use on the GPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import (
    RenderConfig,
    biggraphvis,
    default_config,
    full_layout_colored,
    render_arrays,
)
from repro_torch.core.coloring import write_svg
from repro_torch.graph import mode_degree, planted_partition
from repro_torch.render import write_png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    n = 3000
    edges, _ = planted_partition(n, 30, 0.15, 0.001, seed=42)
    delta = mode_degree(edges, n)
    print(f"graph: {n} nodes, {len(edges)} edges, mode degree δ={delta}")

    out = os.path.dirname(os.path.abspath(__file__))
    cfg = default_config(n, len(edges), delta, rounds=4, iterations=60, s_cap=4096)
    res = biggraphvis(edges, n, cfg, device=args.device)
    # .render() streams the supergraph drawing through the rasterizer on
    # the result's device: superedge splats + supernode disks → PNG.
    res.render(os.path.join(out, "supergraph_torch.png"))
    print(
        f"BigGraphVis on {res.device}: {res.n_supernodes} supernodes, "
        f"{res.n_superedges} superedges, modularity={res.modularity:.3f}"
    )
    print("timings:", {k: f"{v:.2f}s" for k, v in res.timings.items()})
    print("wrote", os.path.join(out, "supergraph_torch.png"))

    live = res.sizes > 0
    drawn = write_svg(
        os.path.join(out, "supergraph_torch.svg"),
        res.positions[live],
        np.sqrt(np.maximum(res.sizes[live], 1.0)),
        res.groups[live],
        device=args.device,
    )
    print("wrote", drawn)

    pos, groups = full_layout_colored(edges, n, cfg, iterations=60, device=args.device)
    drawn = write_svg(
        os.path.join(out, "full_colored_torch.svg"), pos, np.full(n, 2.0), groups,
        edges=edges[:4000], device=args.device,
    )
    print("wrote", drawn)

    # Full-graph raster render: every edge streamed through the raster
    # chunk path (residency independent of |E|), nodes as 2px dots.
    img, rstats = render_arrays(
        pos, np.full(n, 2.0), groups, edges,
        cfg=RenderConfig(width=768, height=768, supersample=2), device=args.device,
    )
    write_png(os.path.join(out, "full_colored_torch.png"), img)
    print(
        f"wrote {os.path.join(out, 'full_colored_torch.png')} "
        f"({rstats.edges_streamed} edge rows in {rstats.chunks} chunks, "
        f"{rstats.edges_per_s / 1e6:.2f}M edges/s)"
    )


if __name__ == "__main__":
    main()
