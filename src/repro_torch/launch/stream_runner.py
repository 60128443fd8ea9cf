"""Launcher for the streaming chunked-edge engine (core/stream.py).

Runs the BigGraphVis pipeline on a planted-partition graph twice — once as
a single chunk (the one-shot path) and once streamed in fixed-size chunks,
from memory or from an on-disk edge store through the pinned staging ring
— and checks that both give the same labels, supergraph and sizes:

    PYTHONPATH=src python -m repro_torch.launch.stream_runner \
        --nodes 20000 --communities 200 --chunk 8192 --rounds 4

prints the comparison, the pass count, chunk throughput, the staging
overlap numbers and peak bytes. With ``--source npy|bin|shards`` the
streamed run reads an edge file written to a temporary directory. With
``--checkpoint-dir`` the streamed run checkpoints at chunk boundaries
(``--checkpoint-every``; 0 = round boundaries) and a SIGTERM checkpoints
at the next boundary and exits 0; ``--resume`` picks the run back up:

    PYTHONPATH=src python -m repro_torch.launch.stream_runner \
        --source npy --checkpoint-dir ckpt --checkpoint-every 8
    PYTHONPATH=src python -m repro_torch.launch.stream_runner \
        --source npy --checkpoint-dir ckpt --checkpoint-every 8 --resume

Runs on CUDA unless ``--device cpu``. One device only: ``--shard`` other
than ``none`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import tempfile
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.pipeline import BGVConfig, BGVResult, biggraphvis
from repro_torch.core.stream import _ROADMAP_MESH, StreamConfig, not_in_slice
from repro_torch.data.edge_store import write_bin, write_npy, write_shards
from repro_torch.obs.cli import add_obs_args, obs_session
from repro_torch.resilience.checkpoint import Preempted, StreamCheckpointer


@dataclass(frozen=True)
class StreamRunnerConfig:
    stream: StreamConfig = StreamConfig()


class StreamRunner:
    """Binds the engine to one device. The engine owns the host→device
    transfer (its pinned staging ring), so the runner only carries the
    configs and the device."""

    def __init__(self, cfg: BGVConfig, runner_cfg: StreamRunnerConfig | None = None,
                 device=None):
        self.cfg = cfg
        self.runner_cfg = runner_cfg or StreamRunnerConfig()
        self.device = device

    def run(self, source, n_nodes: int, checkpoint=None,
            resume: bool | str = False) -> BGVResult:
        """``source``: host edge array, EdgeStore, or edge-file path.
        ``checkpoint``/``resume`` pass through to the streaming pipeline
        (``resilience.StreamCheckpointer``)."""
        return biggraphvis(source, n_nodes, self.cfg, stream=self.runner_cfg.stream,
                           checkpoint=checkpoint, resume=resume, device=self.device)


def _materialize(edges: np.ndarray, source: str, directory: str):
    """Write the edge list to the requested on-disk form; returns a path."""
    if source == "npy":
        return write_npy(f"{directory}/edges.npy", edges)
    if source == "bin":
        return write_bin(f"{directory}/edges.bin", edges)
    write_shards(f"{directory}/shards", edges, shard_edges=max(1, len(edges) // 5))
    return f"{directory}/shards"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--communities", type=int, default=200,
                    help="number of planted communities")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--prefetch", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--agg-backend", choices=("merge", "lexsort"), default="merge",
                    help="superedge aggregation: two-level sorted merge or the "
                         "lexsort re-sort baseline")
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--repulsion", default="exact",
                    choices=("exact", "grid", "grid_pallas", "grid_dense"),
                    help="FA2 repulsion backend for the supergraph layout")
    ap.add_argument("--grid-rebuild", type=int, default=1,
                    help="re-bin/re-sort grid cells every k layout iterations")
    ap.add_argument("--stop-tolerance", type=float, default=0.0,
                    help="FA2 adaptive stop: freeze once global swing <= tol * "
                         "traction (0 = fixed count)")
    ap.add_argument("--min-iterations", type=int, default=0,
                    help="never stop the layout before this many iterations")
    ap.add_argument("--init", default="random", choices=("random", "degree", "bfs"),
                    help="FA2 initial positions")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--source", choices=("memory", "npy", "bin", "shards"),
                    default="memory",
                    help="edge source for the streamed run (non-memory forms are "
                         "written to a temporary directory first)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for streaming detect/supergraph checkpoints "
                         "(atomic .npz + meta.json); also installs a SIGTERM "
                         "handler that checkpoints at the next chunk boundary "
                         "and exits cleanly")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint every N chunk boundaries (0 = round "
                         "boundaries only)")
    ap.add_argument("--checkpoint-keep", type=int, default=3,
                    help="keep the newest K checkpoints")
    ap.add_argument("--resume", action="store_true",
                    help="resume the streamed run from the latest valid "
                         "checkpoint in --checkpoint-dir")
    ap.add_argument("--nan-guard", action="store_true",
                    help="FA2 divergence sentinel: roll back and damp speed on "
                         "non-finite forces")
    ap.add_argument("--shard", choices=("none", "chunks", "detect", "layout", "all"),
                    default="none",
                    help="multi-device mode; only 'none' is ported")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.shard != "none":
        raise not_in_slice(f"--shard {args.shard}", _ROADMAP_MESH)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")

    with obs_session(args):
        _run(args)


def _run(args) -> None:
    from repro_torch.core.pipeline import default_config
    from repro_torch.core.stream import oneshot_device_bytes
    from repro_torch.device import resolve_device
    from repro_torch.graph import mode_degree, planted_partition

    device = resolve_device(args.device)
    n = args.nodes
    edges, _ = planted_partition(n, args.communities, 0.12, 2e-4, seed=args.seed)
    delta = mode_degree(edges, n)
    print(f"graph: {n} nodes, {len(edges)} edges, mode degree δ={delta}, device {device}")

    cfg = default_config(n, len(edges), delta, rounds=args.rounds,
                         iterations=args.iterations, repulsion=args.repulsion,
                         grid_rebuild=args.grid_rebuild,
                         stop_tolerance=args.stop_tolerance,
                         min_iterations=args.min_iterations, init=args.init,
                         nan_guard=args.nan_guard)
    cfg = replace(cfg, scoda=replace(cfg.scoda, block_size=args.block_size))

    ckpt = None
    if args.checkpoint_dir:
        ckpt = StreamCheckpointer(
            args.checkpoint_dir, every_chunks=args.checkpoint_every,
            keep=args.checkpoint_keep, exit_on_preempt=True,
        )
        ckpt.install_preemption_handler()
        print(f"checkpointing to {args.checkpoint_dir} "
              f"(every={args.checkpoint_every or 'round boundaries'}, "
              f"keep={args.checkpoint_keep}; SIGTERM checkpoints and exits)", flush=True)

    res_one = biggraphvis(edges, n, cfg, device=device)
    runner = StreamRunner(cfg, StreamRunnerConfig(stream=StreamConfig(
        chunk_size=args.chunk, prefetch=args.prefetch, agg_backend=args.agg_backend,
    )), device=device)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            if args.source == "memory":
                src = edges
            else:
                src = _materialize(edges, args.source, tmp)
                print(f"streaming from {args.source} store: {src}", flush=True)
            res_str = runner.run(src, n, checkpoint=ckpt, resume=args.resume)
    except Preempted as e:
        print(f"preempted: {e} — checkpoint saved, exiting cleanly "
              f"(restart with --resume)", flush=True)
        raise SystemExit(0)
    if res_str.stream.resumed_at:
        print(f"resumed from checkpoint at {res_str.stream.resumed_at}")

    match = (
        np.array_equal(res_one.labels, res_str.labels)
        and np.array_equal(res_one.supergraph.edges.cpu().numpy(),
                           res_str.supergraph.edges.cpu().numpy())
        and np.array_equal(res_one.sizes, res_str.sizes)
    )
    s = res_str.stream
    print(f"streamed == one-shot: {match}")
    print(f"supernodes={res_str.n_supernodes} superedges={res_str.n_superedges} "
          f"Q={res_str.modularity:.3f}")
    print(f"passes={s.passes} chunks={s.chunks} chunk_size={s.chunk_size} "
          f"throughput={s.edges_per_s / 1e6:.2f}M edges/s")
    print(f"overlap: host_fill={s.host_fill_s * 1e3:.1f}ms "
          f"copy_stall={s.copy_stall_s * 1e3:.1f}ms of {s.seconds * 1e3:.1f}ms")
    print(f"peak host bytes: streamed={s.peak_host_bytes:,} "
          f"(in-memory edge list={edges.nbytes:,})")
    print(f"peak device bytes: streamed={s.peak_device_bytes:,} "
          f"one-shot={res_one.stream.peak_device_bytes:,} "
          f"(one-shot input residency={oneshot_device_bytes(len(edges), n):,})")
    if ckpt is not None:
        print(f"checkpoints: {ckpt.saves} saves, {ckpt.last_bytes:,} bytes the last")


if __name__ == "__main__":
    main()
