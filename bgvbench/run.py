"""Run one benchmark cell once on the card this process is started on.

    python3 -m bgvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output
and each compared number beside its limit as the last lines of standard
error. Exits non-zero, printing no result, without a CUDA card, or when
JAX or the reference package is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One busy host thread (the program's launch loop): no pools of idle
    # math threads beside it.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)
    from bgvbench import harness

    disc = harness.Discovery()
    chips = int(disc.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bgvbench: workload {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           t0=T0, device="cuda", disc=disc)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bgvbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"bgvbench: card {out['device']['kind']}, power limit {power_limit()}",
          file=sys.stderr)
    for name, row in out["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


def power_limit() -> str:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unread ({exc.__class__.__name__})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unread"


if __name__ == "__main__":
    sys.exit(main())
