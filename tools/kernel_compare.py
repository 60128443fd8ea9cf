#!/usr/bin/env python3
"""Time an older tree's grid kernels K6 (near_field) and K7 (segment_sum)
against this tree's, on one GPU, on the inputs the full path gives them.

    git archive <commit> | tar -x -C build/parent    # build/ is ignored by git
    python3 tools/kernel_compare.py build/parent

It runs ``full_layout_colored`` as ``chip_smoke.py`` does (685,230 nodes,
grid 64, window 32, 500 iterations) and records K6's and K7's inputs from
one more iteration at the final layout (``chip_smoke.record_grid_inputs``).
The older tree's ``src/repro_torch/csrc/<name>.cu`` is compiled with this
tree's ``nvcc`` flags and put behind this tree's wrapper (the C interface
is the same), so both versions are called, checked and timed alike: held
bitwise against the plain version, then timed by ``chip_smoke.cuda_ms``
over ``chip_smoke.REPS`` launches queued behind a device sleep, in the
order older, this, this, older, ``ROUNDS`` times. Prints one JSON line
and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

KERNELS = ("near_field", "segment_sum")
ROUNDS = 2


def compile_older(tree: Path, name: str) -> ctypes.CDLL:
    out = build.BUILD_DIR.parent / "kernel_compare" / f"{name}-older.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = tree / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def run(older: Path) -> dict:
    import repro_torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.grid.ref import near_field_ref
    from repro_torch.kernels.segment.ref import segment_sum_ref

    resolve_device("cuda")
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        futs = {k: ex.submit(compile_older, older, k) for k in KERNELS}
        build.build(KERNELS)
        libs = {"older": {k: f.result() for k, f in futs.items()},
                "this": {k: build.library(k) for k in KERNELS}}

    cap = smoke.Capture(torch)
    edges, delta = smoke.make_graph()
    n = smoke.NODES
    cfg = repro_torch.default_config(n, len(edges), delta, grid_size=smoke.GRID,
                                     grid_window=smoke.WINDOW, grid_rebuild=1)
    pos, _ = repro_torch.full_layout_colored(edges, n, cfg, iterations=smoke.FULL_ITERATIONS,
                                             device="cuda")
    smoke.record_grid_inputs(torch, cap, edges, pos)
    _, (pos_s, mass_s, cell_s, kr, w), _ = cap.calls["near_field"]
    _, (data, seg, n_seg), kw = cap.calls["segment_sum"]
    k6, k7 = cap.fn("near_field"), cap.fn("segment_sum")
    calls = {"near_field": lambda: k6(pos_s, mass_s, cell_s, kr, w),
             "segment_sum": lambda: k7(data, seg, n_seg, **kw)}
    want = {"near_field": near_field_ref(pos_s, mass_s, cell_s, kr, w),
            "segment_sum": segment_sum_ref(data.cpu(), seg.cpu(), n_seg)}

    ms = {k: {"older": [], "this": []} for k in KERNELS}
    this_library = build.library
    try:
        for _ in range(ROUNDS):
            for name in KERNELS:
                for version in ("older", "this", "this", "older"):
                    build.library = libs[version].__getitem__
                    smoke.check(torch.equal(calls[name]().cpu(), want[name].cpu()),
                                f"{version} {name} differs from its plain version")
                    ms[name][version].append(smoke.cuda_ms(torch, calls[name], smoke.REPS))
    finally:
        build.library = this_library
    largest = int(torch.bincount(seg[(seg >= 0) & (seg < n_seg)].long()).max())
    return {"input": {"n": int(pos_s.shape[0]), "window": w, "segments": n_seg,
                      "largest_segment": largest},
            "reps": smoke.REPS, "bitwise": True, "ms": ms}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 2
    print(json.dumps(run(Path(sys.argv[1]).resolve())), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
