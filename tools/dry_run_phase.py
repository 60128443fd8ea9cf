#!/usr/bin/env python3
"""``chip_smoke.py``'s training and dry run phases alone, on one card:
builds the kernels, runs ``chip_smoke.training_phase`` (whose one-card
runs leave their recipes and measured peaks) and then
``chip_smoke.dry_run_smoke_phase`` (each kernel rule against its launch,
each training run's peak predicted by a dry step on fake CUDA tensors, the
dry run's CLI on fake CUDA against fake CPU tensors). From the repository
root:

    python3 tools/dry_run_phase.py

Prints the card, each kernel's build seconds, the phases' lines and their
seconds; exits non-zero if a gate fails.
"""
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
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")  # TF32 off
    smi = cs.nvidia_smi_line()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    for name, res in build.build().items():
        print("built", name, round(res.seconds, 2), flush=True)
    t0 = time.time()
    cs.training_phase(torch, np, cs.Capture(torch), smi)
    t1 = time.time()
    cs.dry_run_smoke_phase(torch, np, smi)
    print(f"training phase: {t1 - t0:.3f} s; dry run phase: {time.time() - t1:.3f} s ({smi})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
