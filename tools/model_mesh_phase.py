#!/usr/bin/env python3
"""``chip_smoke.py``'s model mesh phase alone, on one card: builds the
kernels, then runs ``chip_smoke.model_mesh_phase`` (the training cells and
the BigGraphVis cells on 2 ranks sharing the card under gloo, each against
its one-rank step). From the repository root:

    python3 tools/model_mesh_phase.py

Prints the card, each kernel's build seconds, the phase's per-rank lines
and its seconds; exits non-zero if a gate fails.
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
    out = cs.model_mesh_phase(torch, np, smi)
    print(f"model mesh phase: {time.time() - t0:.3f} s, yi-6b at {out['yi_layers']} layers "
          f"({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
