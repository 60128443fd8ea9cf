#!/usr/bin/env python3
"""The dry run's records as a markdown table, one row per (arch, shape),
the (16, 16) and (2, 16, 16) meshes side by side:

    python3 tools/dryrun_table.py [experiments/dryrun_torch]

Columns: bytes a device (GB, against the H100's 80 GB: "over" marks a cell
that does not fit), products' FLOPs, collective payload bytes (GB, ring
factors applied), the kernels' operations (abstract rules) and the
trace's seconds. Skipped cells are listed below the table.
"""
import json
import sys
from pathlib import Path

H100_BYTES = 80e9


def _fmt(recs, key):
    out = []
    for r in recs:
        if r is None or r["status"] != "ok":
            out.append("—")
            continue
        if key == "gb":
            gb = r["bytes_per_device"] / 1e9
            out.append(f"{gb:.2f}" + (" over" if r["bytes_per_device"] > H100_BYTES else ""))
        elif key == "flops":
            out.append(f"{r['hlo_dot_flops']:.3g}")
        elif key == "coll":
            out.append(f"{r['collective_bytes'] / 1e9:.3g}")
        elif key == "kops":
            out.append(f"{sum(k['operations'] for k in r['kernels'].values()):.3g}")
        else:
            out.append(f"{r['trace_s']}")
    return " / ".join(out)


def main() -> int:
    d = Path(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch")
    recs = {}
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    print("| cell | GB a device | dot FLOPs | collective GB | kernel operations | trace s |")
    print("|---|---|---|---|---|---|")
    skipped = []
    for (arch, shape), by in recs.items():
        pair = [by.get("single"), by.get("multi")]
        if all(r is not None and r["status"] == "skipped" for r in pair):
            skipped.append(f"{arch}/{shape}")
            continue
        print(f"| {arch} `{shape}` | " + " | ".join(
            _fmt(pair, k) for k in ("gb", "flops", "coll", "kops", "trace")) + " |")
    print()
    print("Skipped on both meshes: " + ", ".join(skipped) + ".")
    return 0


if __name__ == "__main__":
    sys.exit(main())
