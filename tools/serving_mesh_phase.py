#!/usr/bin/env python3
"""``chip_smoke.py``'s serving mesh phase alone, on one card: runs
``chip_smoke.serving_mesh_phase`` (LM decode on the sequence-sharded KV
cache, prefill with sequence parallelism, SASRec serve and retrieval, on 2
ranks sharing the card under gloo, each against its one-rank step; no
kernel runs in it, so none is built). From the repository root:

    python3 tools/serving_mesh_phase.py [--control]

``--control`` then runs the phase's yi-6b ``decode_32k`` run again with a
deliberately wrong split-K combine on the ranks, one fault at a time, and
prints how far each lands from the one-rank decode, beside the limit
``chip_smoke.SERVE_TOL`` (what the phase's gate reads when split-K is
wrong):

* ``no_rescale``: each rank's exp-sum and output summed without the
  rescale by ``exp(m_rank − m)``;
* ``drop_last_rank``: the last rank's partial left out of the sum.

Prints the card, the phase's per-rank lines and its seconds; exits non-zero
if a gate fails.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FAULTS = ("no_rescale", "drop_last_rank")


def _faulty_combine(fault: str):
    """``layers.combine_partials`` with ``fault`` put in."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.sharding.collectives import all_reduce_axes

    sound = L.combine_partials

    def no_rescale(m, l, o, mesh, axis, dtype):
        packed = all_reduce_axes(torch.cat([o, l[..., None]], dim=-1), mesh, axis, "sum")
        return (packed[..., :-1] / packed[..., -1:]).to(dtype)

    def drop_last_rank(m, l, o, mesh, axis, dtype):
        keep = float(mesh.index(axis) != mesh.extent(axis) - 1)
        return sound(m, l * keep, o * keep, mesh, axis, dtype)

    return {"no_rescale": no_rescale, "drop_last_rank": drop_last_rank}[fault]


def control_rank(_stream_mesh, out_dir: str) -> None:
    """One rank of the control: the yi-6b decode run once a fault, with
    ``combine_partials`` replaced; writes ``out_dir/control{r}.json``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_model_mesh((1, 2), ("data", "model"), backend="gloo")
    sound = L.combine_partials
    out = []
    for fault in FAULTS:
        L.combine_partials = _faulty_combine(fault)
        try:
            info = cs._decode_rank(torch, np, mesh, cs.SERVE_DECODE_RUNS[0], out_dir)
        finally:
            L.combine_partials = sound
        keys = ("rank", "max_abs_logits_vs_one", "window_max_abs_vs_one", "layer0_bitwise",
                "finite", "tol")
        out.append({"fault": fault, **{k: info[k] for k in keys}})
    with open(os.path.join(out_dir, f"control{_stream_mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def control(torch, np, smi: str) -> None:
    import gc

    import chip_smoke as cs
    from repro_torch.launch.mesh import spawn_local

    run = cs.SERVE_DECODE_RUNS[0]
    with tempfile.TemporaryDirectory() as tmp:
        cs._decode_one(torch, np, run, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_local(control_rank, cs.SERVE_RANKS, backend="gloo",
                    init_file=str(Path(tmp) / "store"), args=(tmp,), timeout=cs.SERVE_TIMEOUT)
        ranks = [json.loads((Path(tmp) / f"control{r}.json").read_text())
                 for r in range(cs.SERVE_RANKS)]
    for infos in zip(*ranks):
        print(f"serving mesh control {run[0]} {infos[0]['fault']} " + json.dumps(list(infos)),
              flush=True)
    print(f"serving mesh control: {time.perf_counter() - t0:.3f} s for the spawned ranks "
          f"({smi})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--control", action="store_true",
                    help="then run yi-6b decode_32k with each split-K fault")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device

    resolve_device("cuda")  # TF32 off
    smi = cs.nvidia_smi_line()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    cs.serving_mesh_phase(torch, np, smi)
    print(f"serving mesh phase: {time.time() - t0:.3f} s ({smi})", flush=True)
    if args.control:
        control(torch, np, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
