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

Runs on CUDA unless ``--device cpu``.

Several ranks, one process each: under ``torch.distributed.run`` (its
environment names the ranks) or with ``--ranks N`` (this launcher spawns
them, ``launch.mesh.spawn_local``):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.stream_runner \
        --shard all --device cpu

``--backend gloo`` lets ranks share a card (NCCL needs one per rank).
``--shard`` picks what is spread over the ranks:

* ``detect`` — the per-chunk edge passes (``StreamConfig.shard_detect``):
  each rank reads its rows of every chunk, and the updates merge across
  ranks, bitwise the one-rank result;
* ``layout`` — the supergraph layout's force pass
  (``StreamConfig.shard_layout``), bitwise on the CPU;
* ``chunks`` — placement only: each rank reads whole chunks, holds its
  contiguous rows of each on its device (``StreamRunner.put``, a chunk
  padded with trash rows to a multiple of the rank count), and the rows
  are gathered back before the unsharded update, so the result is bitwise
  the unsharded one. The reference's form of this mode (the compiler
  partitioning the updates around a sharded operand) has no torch
  counterpart;
* ``all`` — the three together (the engine's own placement then takes the
  sharded passes, as in the reference).

Only rank 0 prints the run's summary; ``streamed == one-shot`` holds only
if it holds on every rank. With ``--trace-out``/``--metrics-out``/
``--profile`` rank r > 0 writes its files with a ``.rank{r}`` suffix.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.pipeline import BGVConfig, BGVResult, biggraphvis
from repro_torch.core.stream import StreamConfig
from repro_torch.data.edge_store import write_bin, write_npy, write_shards
from repro_torch.obs.cli import add_obs_args, obs_session
from repro_torch.resilience.checkpoint import Preempted, StreamCheckpointer


@dataclass(frozen=True)
class StreamRunnerConfig:
    stream: StreamConfig = StreamConfig()
    shard_chunks: bool = False  # hold each chunk's rows spread over the mesh


class StreamRunner:
    """Binds the engine to a device, or to a mesh of ranks.

    With a ``mesh`` of several ranks the runner threads it into the engine
    config (every rank is a process of its own, so the engine must know the
    group whatever is sharded: checkpoints are written by rank 0 and a
    SIGTERM is agreed by all), and with ``shard_chunks`` hands the engine
    ``put`` as its host→device transfer of whole chunks: this rank's
    contiguous rows go to the device and the rows of every rank are
    gathered back, so the update sees the whole chunk.

    A chunk whose row count does not divide by the rank count is padded
    with the trash node (a no-op row for every chunk update) to the next
    multiple; ``run`` records the trash node. Before any ``run`` there is no
    sentinel to pad with, so such a chunk is placed whole on every rank."""

    def __init__(self, cfg: BGVConfig, runner_cfg: StreamRunnerConfig | None = None,
                 device=None, mesh=None):
        self.cfg = cfg
        self.runner_cfg = runner_cfg or StreamRunnerConfig()
        self.mesh = mesh
        self.device = device if device is not None or mesh is None else mesh.device
        self._trash = None  # the invalid-edge sentinel (n_nodes); set by run()
        stream = self.runner_cfg.stream
        if mesh is not None and mesh.size > 1 and stream.mesh is None:
            self.runner_cfg = replace(self.runner_cfg, stream=replace(stream, mesh=mesh))

    def _sharding(self) -> bool:
        return (self.mesh is not None and self.mesh.size > 1
                and self.runner_cfg.shard_chunks)

    def place(self, chunk_np: np.ndarray) -> torch.Tensor:
        """This rank's contiguous rows of a host chunk, copied to the device
        (the chunk padded with trash rows to a multiple of the rank count
        once ``run`` set the sentinel); the whole chunk when the runner does
        not shard chunks or has no sentinel for a ragged chunk."""
        rows = np.ascontiguousarray(chunk_np)
        if self._sharding():
            d = self.mesh.size
            rem = rows.shape[0] % d
            if rem and self._trash is not None:
                pad = np.full((d - rem, 2), self._trash, dtype=rows.dtype)
                rows = np.concatenate([rows, pad])
            if rows.shape[0] % d == 0:
                per = rows.shape[0] // d
                rows = rows[self.mesh.rank * per:(self.mesh.rank + 1) * per]
        return torch.tensor(rows, device=self.device)

    def put(self, chunk_np: np.ndarray) -> torch.Tensor:
        """The engine's transfer of one whole chunk: ``place``, then every
        rank's rows gathered in rank order (a padded chunk keeps its trash
        rows)."""
        from repro_torch.sharding.collectives import all_gather_rows

        local = self.place(chunk_np)
        if self._sharding() and local.shape[0] != chunk_np.shape[0]:
            return all_gather_rows(local, self.mesh)
        return local

    def run(self, source, n_nodes: int, checkpoint=None,
            resume: bool | str = False) -> BGVResult:
        """``source``: host edge array, EdgeStore, or edge-file path.
        ``checkpoint``/``resume`` pass through to the streaming pipeline
        (``resilience.StreamCheckpointer``)."""
        self._trash = n_nodes
        return biggraphvis(source, n_nodes, self.cfg, stream=self.runner_cfg.stream,
                           checkpoint=checkpoint, resume=resume, device=self.device,
                           put=self.put if self._sharding() else None)


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
                    help="what the ranks split (see the module docstring): 'chunks' "
                         "holds chunk rows spread (placement only), 'detect' "
                         "spreads the edge passes, 'layout' the supergraph force "
                         "pass, 'all' all three")
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn this many ranks on this host (0: one, or the "
                         "ranks torch.distributed.run started)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend (default: NCCL on CUDA, which "
                         "needs a card per rank; gloo lets ranks share one; "
                         "the CPU always takes gloo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.ranks > 1:
        from repro_torch.launch.mesh import spawn_local

        with tempfile.TemporaryDirectory() as tmp:
            spawn_local(_rank_main, args.ranks, backend=args.backend,
                        device=args.device, init_file=os.path.join(tmp, "store"),
                        args=(args,), timeout=3600.0)
        return
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        _rank_main(None, args)
        return
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_stream_mesh

    mesh = make_stream_mesh(backend=args.backend, device=args.device)
    try:
        try:
            _rank_main(mesh, args)
        except SystemExit as e:  # preempted: every rank stopped at one boundary
            if e.code not in (0, None):
                raise
        # Ranks that finished leave together, with the group taken down: one
        # that left while a peer still held the group could abort in the
        # backend's threads at exit.
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_main(mesh, args) -> None:
    """One rank's run (``mesh`` None: the only one)."""
    if mesh is not None and mesh.rank > 0:
        for name in ("trace_out", "metrics_out", "profile"):
            if getattr(args, name):
                setattr(args, name, f"{getattr(args, name)}.rank{mesh.rank}")
    try:
        with obs_session(args):
            _run(args, mesh)
    except Preempted as e:
        if mesh is None or mesh.rank == 0:
            print(f"preempted: {e} — checkpoint saved, exiting cleanly "
                  f"(restart with --resume)", flush=True)
        raise SystemExit(0)


def _run(args, mesh=None) -> None:
    from repro_torch.core.pipeline import default_config
    from repro_torch.core.stream import oneshot_device_bytes
    from repro_torch.device import resolve_device
    from repro_torch.graph import mode_degree, planted_partition

    device = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    n = args.nodes
    edges, _ = planted_partition(n, args.communities, 0.12, 2e-4, seed=args.seed)
    delta = mode_degree(edges, n)
    say(f"graph: {n} nodes, {len(edges)} edges, mode degree δ={delta}, device {device}")
    if mesh is not None:
        say(f"mesh: {mesh.size} ranks ({mesh.backend}), shard {args.shard}")

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
        say(f"checkpointing to {args.checkpoint_dir} "
            f"(every={args.checkpoint_every or 'round boundaries'}, "
            f"keep={args.checkpoint_keep}; SIGTERM checkpoints and exits)")

    res_one = biggraphvis(edges, n, cfg, device=device)
    runner = StreamRunner(cfg, StreamRunnerConfig(
        stream=StreamConfig(
            chunk_size=args.chunk, prefetch=args.prefetch, agg_backend=args.agg_backend,
            shard_detect=args.shard in ("detect", "all"),
            shard_layout=args.shard in ("layout", "all"),
        ),
        shard_chunks=args.shard in ("chunks", "all"),
    ), device=device, mesh=mesh)
    with tempfile.TemporaryDirectory() as tmp:
        if args.source == "memory":
            src = edges
        else:
            src = _materialize(edges, args.source, tmp)
            say(f"streaming from {args.source} store: {src}")
        res_str = runner.run(src, n, checkpoint=ckpt, resume=args.resume)
    if res_str.stream.resumed_at:
        say(f"resumed from checkpoint at {res_str.stream.resumed_at}")

    match = (
        np.array_equal(res_one.labels, res_str.labels)
        and np.array_equal(res_one.supergraph.edges.cpu().numpy(),
                           res_str.supergraph.edges.cpu().numpy())
        and np.array_equal(res_one.sizes, res_str.sizes)
    )
    if mesh is not None:
        from repro_torch.sharding.collectives import all_reduce

        t = torch.tensor([int(match)], dtype=torch.int32, device=mesh.device)
        match = bool(all_reduce(t, mesh, "min").item())
    s = res_str.stream
    say(f"streamed == one-shot: {match}")
    say(f"supernodes={res_str.n_supernodes} superedges={res_str.n_superedges} "
        f"Q={res_str.modularity:.3f}")
    say(f"passes={s.passes} chunks={s.chunks} chunk_size={s.chunk_size} "
        f"devices={s.devices} throughput={s.edges_per_s / 1e6:.2f}M edges/s")
    say(f"overlap: host_fill={s.host_fill_s * 1e3:.1f}ms "
        f"copy_stall={s.copy_stall_s * 1e3:.1f}ms of {s.seconds * 1e3:.1f}ms")
    say(f"peak host bytes: streamed={s.peak_host_bytes:,} "
        f"(in-memory edge list={edges.nbytes:,})")
    say(f"peak device bytes: streamed={s.peak_device_bytes:,} "
        f"per rank={s.peak_local_bytes:,} "
        f"one-shot={res_one.stream.peak_device_bytes:,} "
        f"(one-shot input residency={oneshot_device_bytes(len(edges), n):,})")
    if ckpt is not None:
        say(f"checkpoints: {ckpt.saves} saves, {ckpt.last_bytes:,} bytes the last")


if __name__ == "__main__":
    main()
