"""Readings the limits of ``limits/<cell>.json`` are set from, on the card at a
cell's own size: for each seed the program's timed unit once against the
reference (the lower readings), and for the control seeds the reference's
floating-point stages in bfloat16 put in the program's place (the upper
readings). One
JSON line per reading.

    python3 -m bgvbench.control --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --out <file.jsonl>
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def readings(unit, digest, device, control: bool) -> list:
    """[(who, numbers, extra)]: the program's, and with ``control`` the
    control's, every number ``unit.compare`` computes."""
    t0 = time.perf_counter()
    ref = unit.reference(device)
    rows = [("program", unit.compare([digest], ref),
             {"reference_s": time.perf_counter() - t0})]
    if unit.kind == "picture":
        rows[0][2]["n_supernodes"] = ref["n_supernodes"]
    if control:
        t0 = time.perf_counter()
        ctl = unit.control(ref, device)
        rows.append(("control", unit.compare([digest], ref, **ctl),
                     {"control_s": time.perf_counter() - t0}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from bgvbench import harness
    from bgvbench import program as program_mod

    if not torch.cuda.is_available():
        print("bgvbench.control: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    disc = harness.Discovery()
    w = disc.workload(args.workload)
    config, mix = disc.config(w["config"]), disc.mix(w["traffic"])
    program = program_mod.load()
    try:
        limits = disc.limits(args.workload)
    except FileNotFoundError:
        limits = {}
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    with open(args.out, "a") as f:
        for s in (int(x) for x in args.seeds.split(",")):
            gen = disc.generator(config["graph"]["generator"])
            edges = gen.generate(config["graph"], s)
            unit = disc.unit(mix["unit"])(program, config, mix, edges,
                                          gen.nodes(config["graph"]), s, dev)
            t0 = time.perf_counter()
            rec = unit.run()
            torch.cuda.synchronize()
            unit_s = time.perf_counter() - t0
            unit.release()
            torch.cuda.empty_cache()
            for who, got, extra in readings(unit, rec["digest"], dev, s in ctl_seeds):
                row = {"workload": args.workload, "seed": s, "who": who, "unit_s": unit_s,
                       "numbers": got,
                       "correct": all(got[k] <= lim for k, lim in limits.items()), **extra}
                line = json.dumps(row)
                print(line, flush=True)
                f.write(line + "\n")
            del unit
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
