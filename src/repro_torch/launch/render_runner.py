"""Launcher for the streaming rasterizer (repro_torch/render).

Runs the BigGraphVis pipeline on a generated (or on-disk) graph and
rasterizes the result on the device: the supergraph drawing by default
(supernode disks radius ∝ √size + weighted superedges, paper §4.3), or
with ``--full`` the full-graph ForceAtlas2 layout with *every* edge
streamed through the raster chunk path — host/device residency
independent of |E|, like the detection engine itself.

    PYTHONPATH=src python -m repro_torch.launch.render_runner \
        --nodes 20000 --communities 200 --out graph.png

    PYTHONPATH=src python -m repro_torch.launch.render_runner \
        --full --width 2048 --height 2048 --supersample 2 --no-edges

    PYTHONPATH=src python -m repro_torch.launch.render_runner \
        --edges edges.npy --nodes 100000 --chunk 65536 --device cpu

prints raster throughput (edges/s, Mpixels/s), chunk counts, and the
renderer's peak device residency. Runs on CUDA unless ``--device cpu``;
the device picks the raster kernels, so there is no backend flag.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.obs.cli import add_obs_args, obs_session
from repro_torch.obs.metrics import REGISTRY


def _report(stats) -> None:
    """Timing report read from the metrics registry (the render stage
    publishes its ``render.*`` gauges there — one source of truth for the
    printout and ``--metrics-out``); only identity fields (sizes/counts)
    come from the stats object."""
    v = REGISTRY.value
    print(
        f"render: {stats.width}x{stats.height} (ss={stats.supersample}) "
        f"nodes={stats.nodes_drawn} edge_rows={stats.edges_streamed} "
        f"chunks={stats.chunks}"
    )
    print(
        f"timings: node_raster={v('render.node_raster_s') * 1e3:.1f}ms "
        f"edge_raster={v('render.edge_raster_s') * 1e3:.1f}ms "
        f"compose={v('render.compose_s') * 1e3:.1f}ms "
        f"total={v('render.seconds') * 1e3:.1f}ms"
    )
    print(
        f"throughput: {v('render.edges_per_s') / 1e6:.2f}M edges/s, "
        f"{v('render.mpixels_per_s'):.1f} Mpixels/s"
    )
    print(f"peak device bytes (render): {int(v('render.peak_device_bytes')):,}")
    if stats.stream is not None:
        s = stats.stream
        print(
            f"edge stream: host_fill={s.host_fill_s * 1e3:.1f}ms "
            f"copy_stall={s.copy_stall_s * 1e3:.1f}ms "
            f"chunks={s.chunks}"
        )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--communities", type=int, default=200)
    ap.add_argument("--edges", default="",
                    help="render an on-disk edge store (.npy/.bin/shard dir) "
                         "instead of generating a graph (requires --nodes)")
    ap.add_argument("--out", default="graph.png")
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--supersample", type=int, default=1)
    ap.add_argument("--edge-samples", type=int, default=8)
    ap.add_argument("--no-edges", action="store_true",
                    help="skip the edge splat pass (nodes only)")
    ap.add_argument("--chunk", type=int, default=1 << 16,
                    help="edges per streamed raster chunk")
    ap.add_argument("--prefetch", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="render the full-graph layout (every edge streamed) "
                         "instead of the supergraph drawing")
    ap.add_argument("--iterations", type=int, default=60)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    with obs_session(args):
        _run(args)


def _run(args) -> None:
    from repro_torch.core.pipeline import (
        biggraphvis,
        default_config,
        full_layout_colored,
    )
    from repro_torch.data.edge_store import open_edge_store
    from repro_torch.device import resolve_device
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree
    from repro_torch.render import RenderConfig, render_arrays, write_png

    device = resolve_device(args.device)
    n = args.nodes
    if args.edges:
        store = open_edge_store(args.edges)
        edges = store.read(0, store.n_edges)
        print(f"graph: {n} nodes, {store.n_edges} edges (from {args.edges})")
    else:
        edges, _ = planted_partition(
            n, args.communities, 0.12, 2e-4, seed=args.seed
        )
        print(f"graph: {n} nodes, {len(edges)} edges (planted partition)")
    delta = mode_degree(edges, n)
    cfg = default_config(n, len(edges), delta, rounds=args.rounds,
                         iterations=args.iterations)
    rcfg = RenderConfig(
        width=args.width, height=args.height, supersample=args.supersample,
        edge_samples=args.edge_samples, draw_edges=not args.no_edges,
        chunk_size=args.chunk, prefetch=args.prefetch,
    )

    if args.full:
        pos, groups = full_layout_colored(
            edges, n, cfg, iterations=args.iterations, device=device
        )
        image, stats = render_arrays(
            pos, np.full(n, 2.0), groups,
            None if args.no_edges else edges, cfg=rcfg, device=device,
        )
        write_png(args.out, image)
    else:
        res = biggraphvis(edges, n, cfg, device=device)
        print(
            f"BigGraphVis: {res.n_supernodes} supernodes, "
            f"{res.n_superedges} superedges, Q={res.modularity:.3f}"
        )
        _image, stats = res.render(args.out, cfg=rcfg)
    print(f"wrote {args.out}")
    _report(stats)


if __name__ == "__main__":
    main()
