#!/usr/bin/env python3
"""``chip_smoke.py``'s checks of the seeded draws alone, on one card
(``chip_smoke.prng_checks``; ``core/prng`` has no kernel, so none is
built): the layouts' uniform starts at the main path's supergraph size and
at the full graph's, the weights' normal draw against the CPU, in chunks
and against the reference's recorded bits, ``split`` against the
reference's, and the timed draws. From the repository root:

    python3 tools/prng_draws.py

Prints the card, the checks' lines and their seconds; exits non-zero if a
check fails.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# The main path's supergraph layout size and the full graph's node count
# (``chip_smoke.py``'s graph), and the layouts' default seed.
SIZES = {"main path supergraph": 16384, "full path": 685_230}
SEED = 0


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device

    if not torch.cuda.is_available():
        print("prng_draws: CUDA is not available", file=sys.stderr)
        return 2
    resolve_device("cuda")
    print(cs.nvidia_smi_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    try:
        cs.prng_checks(torch, SIZES, SEED)
    except Exception as exc:  # a failed check
        print(f"prng_draws: FAILED: {exc}", flush=True)
        return 1
    print(f"prng checks: {time.time() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
