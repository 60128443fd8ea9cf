"""Runs one cell once: discovery by name, set-up, the measured window, the
traced unit, the outputs check and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives: ``configs/<config>.json`` (with ``gen/<generator>.py``),
``traffic/<mix>.json`` (whose ``unit`` names ``units/<kind>.py``) and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from bgvbench import devtrace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Discovery:
    """The files of one benchmark folder and its ``BENCHMARK.json``."""

    def __init__(self, bench: Path = BENCH, spec_path: Path | None = None):
        self.bench = Path(bench)
        self.spec = json.loads(Path(spec_path or self.bench.parent / "BENCHMARK.json")
                               .read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.bench / "configs" / f"{name}.json").read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def _module(self, kind: str, name: str):
        path = self.bench / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"bgvbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def limits(self, cell: str) -> dict:
        """{number: limit} the cell's outputs are judged by
        (``limits/<cell>.json``, beside the readings each was set from)."""
        rows = json.loads((self.bench / "limits" / f"{cell}.json").read_text())
        return {name: row["limit"] for name, row in rows["limits"].items()}

    def generator(self, name: str):
        return self._module("gen", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def unit(self, kind: str):
        """The ``Unit`` class of ``units/<kind>.py``."""
        return self._module("units", kind).Unit

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


class Context:
    """What a per-layer metric's ``read(ctx)`` may read."""

    def __init__(self, records: list, trace, shapes: dict):
        self.records, self.trace, self.shapes = records, trace, shapes

    def mean(self, key: str):
        """Mean of a record field over the window's units."""
        vals = [r[key] for r in self.records if key in r]
        return statistics.fmean(vals) if vals else None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device="cuda", disc: Discovery | None = None, program=None) -> dict:
    """One run of ``cell`` → the result line's object (``compared`` last)."""
    from bgvbench import program as program_mod

    disc = disc or Discovery()
    w = disc.workload(cell)
    config, mix = disc.config(w["config"]), disc.mix(w["traffic"])
    program = program or program_mod.load()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_gen = time.perf_counter()
    gen = disc.generator(config["graph"]["generator"])
    edges = gen.generate(config["graph"], seed)
    unit = disc.unit(mix["unit"])(program, config, mix, edges, gen.nodes(config["graph"]),
                                  seed, dev)
    t_warm = time.perf_counter()
    unit.warm()
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: imports and program {t_gen - t0:.3f} s, graph "
        f"{t_warm - t_gen:.3f} s ({len(edges)} edges), warm-up unit "
        f"{setup_s - (t_warm - t0):.3f} s")

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    records = []
    start = time.perf_counter()
    while True:
        t_unit = time.perf_counter()
        rec = unit.run()
        rec["seconds"] = time.perf_counter() - t_unit
        records.append(rec)
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"units' seconds {[round(r['seconds'], 3) for r in records]}")
    digests = [r["digest"] for r in records]
    dtrace = None
    if trace:
        # After the window, so that the profiler slows none of its units;
        # held to the window's outputs below.
        t_unit = time.perf_counter()
        extra, dtrace = devtrace.traced(unit.run)
        digests.append(extra["digest"])
        log(f"traced unit {dtrace.window_s:.3f} s, "
            f"{time.perf_counter() - t_unit:.3f} s with the trace's reduction")

    shapes = unit.shapes()
    unit.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = unit.check(digests, dev)
    compared = {k: (numbers[k], lim) for k, lim in disc.limits(cell).items()}
    log(f"window {window_s:.3f} s, {len(records)} units; outputs check "
        f"{time.perf_counter() - t_check:.3f} s")
    correct = all(v <= lim for v, lim in compared.values())
    failed = 0 if correct else (compared.get("units_differ", (0, 0))[0]
                                or len(records))

    metrics = {}
    if not trace:
        metrics[mix["metric"]] = {"value": window_s / len(records),
                                  "unit": _unit_of(disc, mix["metric"])}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = Context(records, dtrace, shapes)
        for m in disc.per_layer(cell):
            value = disc.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(records), "failed": int(failed),
           "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        out["breakdown"] = {"device_ops": dtrace.top_kernels(),
                            "idle_gaps": dtrace.top_idle()}
    out["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out


def log(msg: str) -> None:
    print(f"bgvbench: {msg}", file=sys.stderr, flush=True)


def _unit_of(disc: Discovery, metric: str) -> str:
    for m in disc.spec["end_to_end"]:
        if m["name"] == metric:
            return m["unit"]
    raise KeyError(f"end-to-end metric {metric!r} is not in BENCHMARK.json")
