"""The dry run on the production meshes: every (architecture × input shape
× mesh) cell of the registry traced on fake tensors, and what one rank of
it holds and does, recorded. The port's counterpart of the reference's
``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] \\
        [--device cuda|cpu]

The reference lowers and compiles each cell for the 256- and 512-device
meshes on host devices. The port answers the same question for ranks that
are H100s: each cell runs in a process of its own (a fake world is
process-global), which starts a fake process group of 256 or 512 ranks
(``torch.testing``'s ``FakeStore``, backend "fake": collectives return at
once), builds rank 0's mesh with ``make_production_mesh``, the step with
``build_step(arch, shape, mesh)``, rank 0's blocks of its abstract inputs
under its ``in_specs`` as fake tensors, and runs the step once under
``FakeTensorMode`` and ``op_analysis.OpCounter``. No kernel launches: each
kernel entry takes its abstract rule (``kernels/build.py``). A cell on the
(2, 16, 16) mesh is traced again as its last rank (511), and the record
lists any number that differs from rank 0's (``last_rank``).

``--device cuda`` (the default) makes the fake tensors CUDA tensors: it
needs a CUDA build of torch, not a card. ``--device cpu`` makes them CPU
tensors, for a torch without CUDA; the kernels take the same rules either
way, so the records agree (``chip_smoke.py`` checks that on the card).

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(never in the reference's ``experiments/dryrun/``) with the reference's
keys: ``memory`` (its five keys, from the live bytes), ``bytes_per_device``
(its formula), ``cost`` (``flops``: the products' and the kernels'
operations; ``bytes accessed``: the products' and the kernels' bytes),
``hlo_dot_flops``, ``hlo_dot_traffic``, ``collective_bytes``,
``collective_counts``, ``n_dots``, ``meta``; ``trace_s`` (the trace's
seconds) stands for ``lower_s`` and ``compile_s``; ``kernels`` holds each
kernel entry's rule calls, operations and bytes. The reference's
``--save-hlo`` has no counterpart (there is no HLO), nor its ``n_whiles``
(``op_analysis``). The process exits 1 if any cell errors.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
# Cells traced at once (a process each, single-threaded): the cores but two.
JOBS = max(1, (os.cpu_count() or 1) - 2)
_MEM_KEYS = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes")
# The numbers compared between rank 0 and the last rank of a (2, 16, 16) cell.
_RANK_KEYS = ("bytes_per_device", "hlo_dot_flops", "hlo_dot_traffic", "collective_bytes",
              "n_dots")


def _block_shape(shape, spec, mesh) -> tuple:
    from repro_torch.sharding.params import local_block

    return tuple(len(range(*s.indices(n)))
                 for s, n in zip(local_block(shape, spec, mesh, mesh.coords), shape))


def fake_inputs(built, mesh, device):
    """Rank ``mesh.rank``'s blocks of ``built.abstract_args`` under
    ``built.in_specs``, as empty tensors of the active (fake) mode on
    ``device``."""
    import torch

    from repro_torch.sharding.rules import _map2

    def one(a, spec):
        return torch.empty(_block_shape(tuple(a.shape), tuple(getattr(spec, "spec", spec)), mesh),
                           dtype=a.dtype, device=device)

    return tuple(_map2(one, a, s) for a, s in zip(built.abstract_args, built.in_specs))


def trace(fn, make_args):
    """Run ``fn(*make_args())`` once, its arguments made inside a fresh
    ``FakeTensorMode`` and counted as its inputs, under an ``OpCounter``;
    returns the ``OpStats`` and the seconds the trace took."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpCounter

    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=False):
        args = make_args()
        with OpCounter() as counter:
            counter.track_inputs(args)
            out = fn(*args)
            counter.track_outputs(out)
            del out
    return counter.stats, time.perf_counter() - t0


def trace_step(built, mesh, device):
    """``trace`` of ``built.fn`` on rank ``mesh.rank``'s fake blocks of its
    inputs."""
    return trace(built.fn, lambda: fake_inputs(built, mesh, device))


def record(stats, seconds: float, n_devices: int, meta: dict) -> dict:
    """The reference's record keys from one trace."""
    mem = stats.memory()
    k_ops, k_bytes = stats.kernel_totals()
    return {
        "status": "ok",
        "n_devices": n_devices,
        "trace_s": round(seconds, 1),
        "memory": mem,
        "bytes_per_device": (sum(mem[k] for k in _MEM_KEYS) - mem["alias_size_in_bytes"]),
        "cost": {"flops": stats.dot_flops + k_ops,
                 "bytes accessed": stats.dot_traffic_bytes + k_bytes},
        "hlo_dot_flops": stats.dot_flops,
        "hlo_dot_traffic": stats.dot_traffic_bytes,
        "collective_bytes": stats.collective_bytes,
        "collective_counts": stats.collective_counts,
        "collective_calls": stats.collective_calls,
        "n_dots": stats.n_dots,
        "kernels": stats.kernels,
        "meta": meta,
    }


def trace_cell(arch_name: str, shape_name: str, mesh_kind: str, device: str,
               rank: int = 0) -> dict:
    """One cell as rank ``rank`` of a fake world (this process's only
    world): its record's measured keys."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step

    arch = get_config(arch_name)
    world = 512 if mesh_kind == "multi" else 256
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=device)
        built = build_step(arch, arch.shapes[shape_name], mesh)
        stats, seconds = trace_step(built, mesh, mesh.device)
        return record(stats, seconds, mesh.size, built.meta)
    finally:
        dist.destroy_process_group()


def _path(out_dir: str, arch_name: str, shape_name: str, mesh_kind: str) -> str:
    return os.path.join(out_dir, f"{arch_name}__{shape_name}__{mesh_kind}.json")


def run_cell(arch_name: str, shape_name: str, mesh_kind: str, out_dir: str, device: str,
             rank: int = 0) -> dict:
    """Trace one cell in this process and write its record (the child's
    side of ``--all``; the parent starts one process a cell)."""
    from repro_torch.configs import get_config

    os.makedirs(out_dir, exist_ok=True)
    arch = get_config(arch_name)
    shape = arch.shapes[shape_name]
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
           "status": "", "profile": arch.profile, "rank": rank}
    if shape.skip:
        rec.update(status="skipped", skip_reason=shape.skip)
    else:
        try:
            rec.update(trace_cell(arch_name, shape_name, mesh_kind, device, rank))
        except Exception as e:  # record the failure: it is a bug to fix
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
            rec["traceback"] = traceback.format_exc()[-4000:]
            print(f"[{arch_name}/{shape_name}/{mesh_kind}] FAILED: {rec['error'][:200]}")
    with open(_path(out_dir, arch_name, shape_name, mesh_kind), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _start(args, arch_name, shape_name, mesh_kind, out_dir, rank=0):
    """Start one cell's trace in a fresh process."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_name,
           "--shape", shape_name, "--mesh", mesh_kind, "--device", args.device,
           "--out", out_dir, "--one", "--rank", str(rank)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(proc, arch_name, shape_name, mesh_kind, out_dir) -> dict:
    """The record a started process wrote (an error record if it died
    without one)."""
    log, _ = proc.communicate()
    path = _path(out_dir, arch_name, shape_name, mesh_kind)
    if proc.returncode == 0 and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"arch": arch_name, "shape": shape_name, "mesh": mesh_kind, "status": "error",
            "error": f"the cell's process exited {proc.returncode}", "traceback": log[-4000:]}


def _cell(args, arch_name: str, shape_name: str, mesh_kind: str) -> dict:
    """A cell's record: rank 0's trace, and on the (2, 16, 16) mesh the last
    rank's numbers beside it (traced at the same time) with the keys that
    differ."""
    from repro_torch.configs import get_config

    path = _path(args.out, arch_name, shape_name, mesh_kind)
    if os.path.exists(path) and not args.force:
        with open(path) as f:
            return json.load(f)
    if get_config(arch_name).shapes[shape_name].skip:  # nothing to trace
        return run_cell(arch_name, shape_name, mesh_kind, args.out, args.device)
    cell = (arch_name, shape_name, mesh_kind)
    first = _start(args, *cell, args.out)
    if mesh_kind != "multi":
        return _finish(first, *cell, args.out)
    scratch = tempfile.mkdtemp(prefix=".rank511-", dir=args.out)
    try:
        last = _finish(_start(args, *cell, scratch, rank=511), *cell, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    rec = _finish(first, *cell, args.out)
    if rec["status"] != "ok":
        return rec
    if last["status"] == "ok":
        rec["last_rank"] = {"rank": 511, **{k: last[k] for k in _RANK_KEYS},
                            "differs": [k for k in _RANK_KEYS if last[k] != rec[k]]}
    else:
        rec.update(status="error", error="rank 511: " + last.get("error", ""),
                   traceback=last.get("traceback", ""))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    from repro_torch.obs.cli import add_obs_args, obs_session

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (cuda needs a CUDA build of torch, "
                         "not a card)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    add_obs_args(ap)
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out)
    if args.one:  # one cell, in this process
        rec = run_cell(args.arch, args.shape, args.mesh, args.out, args.device, args.rank)
        raise SystemExit(0 if rec["status"] != "error" else 1)
    os.makedirs(args.out, exist_ok=True)
    with obs_session(args):
        _run(args)


def _run(args) -> None:
    from repro_torch.configs import REGISTRY, get_config

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(name, s) for name, builder in REGISTRY.items() for s in builder().shapes]
    else:
        arch = get_config(args.arch)
        cells = [(args.arch, s) for s in ([args.shape] if args.shape else list(arch.shapes))]
    jobs = [(a, s, m) for a, s in cells for m in meshes]
    with ThreadPoolExecutor(JOBS) as pool:
        recs = list(pool.map(lambda c: _cell(args, *c), jobs))
    n_ok = n_fail = n_skip = 0
    for (arch_name, shape_name, mk), rec in zip(jobs, recs):
        s = rec["status"]
        n_ok += s == "ok"
        n_fail += s == "error"
        n_skip += s == "skipped"
        print(f"  -> {arch_name}/{shape_name}/{mk}: {s} "
              f"(trace {rec.get('trace_s', '-')}s, "
              f"{rec.get('bytes_per_device', 0) / 2**30:.2f} GiB/dev)"
              + (f" {rec.get('error', '')[:200]}" if s == "error" else ""))
    print(f"dry-run done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
