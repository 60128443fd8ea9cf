#!/usr/bin/env python3
"""``chip_smoke.py``'s models phase alone, on one card: builds the kernels,
then runs ``chip_smoke.models_phase`` (yi-6b and granite-moe through
``LMEngine``, both LMs at 2 layers against the CPU, SASRec's serve and
retrieval cells, gin-tu and gat-cora). From the repository root:

    python3 tools/models_phase.py

Prints the card, each kernel's build seconds, the phase's lines and its
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
    cs.models_phase(torch, np, cs.Capture(torch), smi)
    print(f"models phase: {time.time() - t0:.3f} s ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
