#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, and what one call costs, when
several ranks share one card.

Spawns ``--world`` ranks (default 2 and 4) on ``cuda:0`` under the gloo
backend with a ``file://`` store and, for each collective the multi-device
paths use (all-gather of a tensor list, all-reduce SUM, MAX and MIN), runs
it once on CUDA tensors of int32, int64 and float32, checks the result
against the same collective on host tensors, and times ``--reps`` calls at
two sizes: a SCoDA block's exchange (2,048 rows × 2 int32 from each rank)
and a per-chunk all-reduce of node state (685,231 int32). Prints one JSON
line per world size with the card's name and power limit.

    python3 tools/collective_probe.py [--world 2 4] [--reps 200]

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def _worker(rank, world, init_file, reps, out_dir):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = {"rank": rank, "accepts_cuda": {}, "ms": {}}
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    for dtype in (torch.int32, torch.int64, torch.float32):
        x = (torch.arange(10, dtype=torch.float64) * (rank + 1)).to(dtype)
        parts = [torch.empty_like(x) for _ in range(world)]
        want = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(want, x)
        try:
            got = [torch.empty_like(x, device=dev) for _ in range(world)]
            dist.all_gather(got, x.to(dev))
            ok = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            res["accepts_cuda"][f"all_gather.{dtype}"] = bool(ok)
        except Exception as e:  # recorded, not hidden: the line says which
            res["accepts_cuda"][f"all_gather.{dtype}"] = f"{type(e).__name__}: {e}"
        del parts
        for name, op in ops.items():
            h = x.clone()
            dist.all_reduce(h, op=op)
            try:
                c = x.to(dev)
                dist.all_reduce(c, op=op)
                res["accepts_cuda"][f"all_reduce.{name}.{dtype}"] = bool(
                    torch.equal(c.cpu(), h))
            except Exception as e:
                res["accepts_cuda"][f"all_reduce.{name}.{dtype}"] = (
                    f"{type(e).__name__}: {e}")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    blk = torch.zeros((2048, 2), dtype=torch.int32, device=dev)
    blk_parts = [torch.empty_like(blk) for _ in range(world)]
    node = torch.zeros(685_231, dtype=torch.int32, device=dev)
    res["ms"]["all_gather_block_cuda"] = timed(lambda: dist.all_gather(blk_parts, blk))
    res["ms"]["all_reduce_max_node_cuda"] = timed(
        lambda: dist.all_reduce(node, op=dist.ReduceOp.MAX))
    hb = blk.cpu()
    hb_parts = [torch.empty_like(hb) for _ in range(world)]
    res["ms"]["all_gather_block_host"] = timed(lambda: dist.all_gather(hb_parts, hb))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("collective_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for world in args.world:
        with tempfile.TemporaryDirectory() as tmp:
            init = os.path.join(tmp, "store")
            ctx = mp.start_processes(_worker, args=(world, init, args.reps, tmp),
                                     nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + 300
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"world {world}: ranks did not finish")
            ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                     for r in range(world)]
        print(json.dumps({"world": world, "torch": torch.__version__, "card": smi,
                          "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
