#!/usr/bin/env python3
"""``chip_smoke.py``'s bfloat16 phase alone, on one card: builds the
kernels, drives the main path once at the smoke's size (recording each
kernel's inputs), records the full path's grid inputs from its seeded
start, then runs ``chip_smoke.half_layout_phase`` (K2 and K7's attraction
in bfloat16 and float16 against their plain versions, the main path's
supergraph and the full path's grid layout in bfloat16, a small bfloat16
layout against the CPU) and ``chip_smoke.time_half_kernels``, with the
float32 entries timed beside the bfloat16 ones on the same recorded inputs
in the same call. From the repository root:

    python3 tools/half_layout_phase.py

Prints the card, the phase's lines, the timed rows and the seconds; exits
non-zero if a gate fails.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")  # TF32 off
    smi = cs.nvidia_smi_line()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    for name, res in build.build().items():
        print("built", name, round(res.seconds, 2), flush=True)
    cap = cs.Capture(torch)
    edges, delta = cs.make_graph()
    n = cs.NODES
    cfg = repro_torch.default_config(n, len(edges), delta, iterations=cs.ITERATIONS)
    t0 = time.time()
    with cap.recording():
        res = repro_torch.biggraphvis(edges, n, cfg,
                                      repro_torch.StreamConfig(chunk_size=cs.MAIN_CHUNK),
                                      device="cuda")
    torch.cuda.synchronize()
    print(f"main path (recording) {time.time() - t0:.3f} s, layout_s "
          f"{res.timings['layout_s']}", flush=True)
    start = fa2.init_positions(n, cfg.layout.seed, device="cuda").cpu().numpy()
    cs.record_grid_inputs(torch, cap, edges, start)
    t0 = time.time()
    half = cs.half_layout_phase(torch, np, cap, edges, res, cfg)
    t1 = time.time()
    rows = []
    by_path = {**half["launches"], "multi_bf16": {}}
    cs.time_half_kernels(torch, np, cap,
                         lambda *a, **k: rows.append(cs.kernel_row(by_path, *a, **k)))
    # The float32 entries on the same recorded inputs, in this call.
    _, (p, m, kr), kw = cap.calls["repulsion_nbody"]
    radii = kw.get("radii")
    k2 = cap.fn("repulsion_nbody")
    from repro_torch.kernels.repulsion import ops as rep_ops

    i0, nl = p.shape[0] // 2, p.shape[0] - p.shape[0] // 2
    f32 = {"repulsion_nbody": cs.cuda_ms(torch, lambda: k2(p, m, kr, radii=radii), cs.REPS),
           "repulsion_rows": cs.cuda_ms(
               torch, lambda: rep_ops.repulsion_rows(p, m, i0, nl, kr, radii=radii), cs.REPS)}
    k7 = cap.fn("attraction_sum")
    for tag, suffix in (("", ""), ("@full", "_full")):
        _, (pos, dst, w, lay), _ = cap.calls["attraction_sum" + tag]
        f32["attraction_sum" + suffix] = cs.cuda_ms(torch, lambda: k7(pos, dst, w, lay), cs.REPS)
    print("float32 ms, same call " + json.dumps(f32), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"bfloat16 phase: {t1 - t0:.3f} s; rows {time.time() - t1:.3f} s ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
