"""Serving launcher: the interactive tile-pyramid layout service.

    PYTHONPATH=src python -m repro_torch.launch.serve --nodes 3000 --depth 3
    PYTHONPATH=src python -m repro_torch.launch.serve --edges edges.npy --nodes 50000
    PYTHONPATH=src python -m repro_torch.launch.serve --nodes 300 --device cpu

Computes a BigGraphVis layout (synthetic planted-partition graph by
default, or any ``repro_torch.data.edge_store`` source via ``--edges``),
builds the tile pyramid (``repro_torch/serve/tiles.py``), precomputes every
pyramid level and the drill pool into the LRU cache, and serves a
synthetic zipfian pan/zoom trace, reporting tiles/s, cache hit rate,
miss-latency percentiles and the kernel builds during the trace (zero at
steady state). ``--out`` writes the level-0 tile as a PNG.

Runs on CUDA unless ``--device cpu``. The port has no persistent compile
cache to point at: its only compiled artifacts are the kernel libraries,
which ``nvcc`` builds at first use into ``build/repro_torch_kernels/`` and
a restarted service reuses.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.obs.cli import add_obs_args, obs_session


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if len(values) else 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Interactive tile-pyramid layout service over a "
                    "BigGraphVis result"
    )
    ap.add_argument("--edges", default="",
                    help="edge source (.npy/.bin/shard dir); default: "
                         "synthetic planted-partition graph")
    ap.add_argument("--nodes", type=int, default=3000, help="node count")
    ap.add_argument("--communities", type=int, default=30,
                    help="planted communities (synthetic graph only)")
    ap.add_argument("--depth", type=int, default=3,
                    help="pyramid levels (level z = 2^z x 2^z tiles)")
    ap.add_argument("--tile-size", type=int, default=256,
                    help="square tile resolution in pixels")
    ap.add_argument("--cache-mb", type=float, default=64.0,
                    help="tile cache capacity in MiB")
    ap.add_argument("--slots", type=int, default=8,
                    help="max tile renders per engine tick")
    ap.add_argument("--iterations", type=int, default=60,
                    help="supergraph FA2 iterations")
    ap.add_argument("--requests", type=int, default=400,
                    help="synthetic pan/zoom requests to serve")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="zipf exponent of the tile popularity ranking")
    ap.add_argument("--drill-frac", type=float, default=0.05,
                    help="fraction of requests drilling into a community")
    ap.add_argument("--seed", type=int, default=0, help="traffic seed")
    ap.add_argument("--out", default="",
                    help="write the level-0 tile to this PNG")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    with obs_session(args):
        _run(args)


def _run(args) -> None:
    from repro_torch.core.pipeline import biggraphvis, default_config
    from repro_torch.device import resolve_device
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree
    from repro_torch.render.png import write_png
    from repro_torch.serve.tiles import (
        DrillSpec,
        TileConfig,
        TileEngine,
        TilePyramid,
        TileRequest,
        TileSpec,
        jit_compile_count,
        synthetic_trace,
    )

    device = resolve_device(args.device)
    n = args.nodes
    if args.edges:
        from repro_torch.data.edge_store import as_edge_store

        store = as_edge_store(args.edges)
        edges = store.read(0, store.n_edges)
    else:
        edges, _ = planted_partition(
            n, args.communities, 0.15, 0.001, seed=42
        )
    print(f"graph: {n} nodes, {len(edges)} edges on {device}")

    cfg = default_config(
        n, len(edges), mode_degree(np.asarray(edges), n),
        iterations=args.iterations, s_cap=min(n, 4096),
    )
    t0 = time.perf_counter()
    result = biggraphvis(edges, n, cfg, device=device)
    print(
        f"layout: {result.n_supernodes} supernodes, "
        f"{result.n_superedges} superedges, Q={result.modularity:.3f} "
        f"in {time.perf_counter() - t0:.1f}s"
    )

    pyramid = TilePyramid(
        result,
        TileConfig(tile_size=args.tile_size, depth=args.depth),
        source=edges,
        bgv_cfg=cfg,
    )
    engine = TileEngine(
        pyramid, cache_bytes=int(args.cache_mb * (1 << 20)), slots=args.slots
    )

    t0 = time.perf_counter()
    # Warm the full serving mix: every pyramid tile plus the drill pool the
    # trace samples from.
    drill_pool = pyramid.drillable_communities()[:8]
    warmed = engine.warmup(drills=drill_pool)
    n_tiles = sum(pyramid.n_tiles(z) ** 2 for z in range(args.depth))
    print(
        f"warmup: {warmed} tiles ({n_tiles} pyramid + {len(drill_pool)} "
        f"drill-downs) precomputed in {time.perf_counter() - t0:.1f}s "
        f"({engine.cache.bytes / (1 << 20):.1f} MiB cached)"
    )
    if args.out:
        print(f"wrote {write_png(args.out, engine.request(TileSpec(0, 0, 0)))}")

    trace = synthetic_trace(
        pyramid, args.requests, zipf_a=args.zipf,
        drill_frac=args.drill_frac, seed=args.seed,
    )
    c0 = jit_compile_count()
    hits0 = engine.cache.hits
    miss_lat: list[float] = []
    t0 = time.perf_counter()
    for spec in trace:
        req = TileRequest(spec)
        engine.submit(req)
        while not req.done:
            engine.tick()
        if not req.hit:
            miss_lat.append(req.latency_s)
    dt = time.perf_counter() - t0

    served = len(trace)
    hits = engine.cache.hits - hits0
    drills = sum(1 for s in trace if isinstance(s, DrillSpec))
    print(
        f"served {served} requests ({drills} drill-downs) in {dt:.1f}s: "
        f"{served / dt:.1f} tiles/s, hit rate {hits / max(served, 1):.1%}, "
        f"{len(miss_lat)} misses "
        f"(p50 {percentile(miss_lat, 50) * 1e3:.0f}ms, "
        f"p99 {percentile(miss_lat, 99) * 1e3:.0f}ms)"
    )
    print(
        f"steady-state kernel builds: {jit_compile_count() - c0}, "
        f"cache: {len(engine.cache)} tiles / "
        f"{engine.cache.bytes / (1 << 20):.1f} MiB, "
        f"{engine.cache.evictions} evictions, {engine.ticks} ticks, "
        f"{engine.failed} failed tiles"
    )


if __name__ == "__main__":
    main()
