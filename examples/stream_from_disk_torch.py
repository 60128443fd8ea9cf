"""Streaming from disk on PyTorch/CUDA: the port's BigGraphVis over an edge
list that never has to fit in host memory, checkpointed and resumed.

    PYTHONPATH=src python examples/stream_from_disk_torch.py               # GPU
    PYTHONPATH=src python examples/stream_from_disk_torch.py --device cpu

Writes a graph to an on-disk edge store, then drives the pipeline from the
memory-mapped file: the only chunk-sized host buffers in play are the
pinned staging ring's, and the result is bit-for-bit the in-memory run's.
It then kills a checkpointed run mid-detect (``resilience.KillSwitch``)
and resumes it from its last checkpoint to the same result.

The stores are produced and inspected from the shell with the converter:

    PYTHONPATH=src python -m repro_torch.data.edge_store info edges.npy
    PYTHONPATH=src python -m repro_torch.data.edge_store convert edges.npy shards/ \\
        --format shards --shard-edges 1000000
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import StreamConfig, biggraphvis, default_config
from repro_torch.data.edge_store import write_npy
from repro_torch.graph import mode_degree, planted_partition
from repro_torch.resilience import KillSwitch, SimulatedPreemption, StreamCheckpointer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    n = 3000
    edges, _ = planted_partition(n, 30, 0.15, 0.001, seed=42)
    cfg = default_config(
        n, len(edges), mode_degree(edges, n), rounds=4, iterations=30, s_cap=4096
    )
    stream = StreamConfig(chunk_size=8192, prefetch=1, agg_backend="merge")

    with tempfile.TemporaryDirectory() as tmp:
        path = write_npy(os.path.join(tmp, "edges.npy"), edges)
        print(f"graph: {n} nodes, {len(edges)} edges -> {path}")
        res_disk = biggraphvis(path, n, cfg, stream=stream, device=args.device)
        res_mem = biggraphvis(edges, n, cfg, stream=stream, device=args.device)

        # Kill a checkpointed run at its 10th chunk boundary, then resume.
        ckdir = os.path.join(tmp, "ckpt")
        ck = StreamCheckpointer(ckdir, every_chunks=4, on_boundary=KillSwitch(10))
        try:
            biggraphvis(path, n, cfg, stream=stream, checkpoint=ck, device=args.device)
        except SimulatedPreemption as e:
            print(f"killed: {e} ({ck.saves} checkpoints written)")
        res_resumed = biggraphvis(path, n, cfg, stream=stream,
                                  checkpoint=StreamCheckpointer(ckdir, every_chunks=4),
                                  resume=True, device=args.device)

    def same(a, b):
        return np.array_equal(a.labels, b.labels) and np.array_equal(
            a.supergraph.edges.cpu().numpy(), b.supergraph.edges.cpu().numpy())

    s = res_disk.stream
    print(f"device: {res_disk.device}")
    print(f"disk-streamed == in-memory: {same(res_mem, res_disk)}")
    print(f"resumed at {res_resumed.stream.resumed_at} == uninterrupted: "
          f"{same(res_disk, res_resumed)}")
    print(
        f"supernodes={res_disk.n_supernodes} superedges={res_disk.n_superedges} "
        f"modularity={res_disk.modularity:.3f}"
    )
    print(f"passes={s.passes} chunks={s.chunks} "
          f"throughput={s.edges_per_s / 1e6:.2f}M edges/s")
    print(f"host bytes while streaming: {s.peak_host_bytes:,} "
          f"(staging ring only; edge list itself is {edges.nbytes:,})")
    print(f"overlap: host_fill={s.host_fill_s * 1e3:.1f}ms "
          f"copy_stall={s.copy_stall_s * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
