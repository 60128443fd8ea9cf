"""The harness finds a configuration, a traffic mix, a kind of unit, a
per-layer metric and a cell's limits by the name BENCHMARK.json gives,
with no edit to a file it already has."""
import json
import shutil
import time

from bgvbench import harness
from conftest import tiny_config

DEGREE_UNIT = '''"""A new kind of unit: the degree sum of the graph on the device."""
import numpy as np
import torch


class Unit:
    kind = "degree_sum"

    def __init__(self, program, config, mix, edges, n, seed, device):
        self.edges = torch.as_tensor(edges, device=device)
        self.n, self.want = n, 2 * len(edges)

    def run(self):
        deg = torch.bincount(self.edges.reshape(-1), minlength=self.n)
        self.got = int(deg.sum())
        return {"digest": str(self.got)}

    warm = run

    def shapes(self):
        return {"n": self.n}

    def release(self):
        self.edges = None

    def check(self, digests, device):
        return {"units_differ": sum(d != digests[-1] for d in digests),
                "degree_gap": abs(self.got - self.want)}
'''

METRIC = ('LAYER = "entry"\nUNIT = "count"\nSOURCE = "program_counter"\n'
          'MOVES = "{moves}"\n\n\ndef read(ctx):\n    return len(ctx.records)\n')


def test_new_config_mix_unit_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "bgvbench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = tiny_config(json.loads((bench / "configs" / "graph500.json").read_text()))
    cfg["name"] = "tinykron"
    (bench / "configs" / "tinykron.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "fa2_full.json").read_text())
    mix["iterations"] = 10
    (bench / "traffic" / "quick_layout.json").write_text(json.dumps(mix))
    (bench / "traffic" / "degrees.json").write_text(json.dumps(
        {"unit": "degree_sum", "metric": "degrees_s", "what": "test"}))
    (bench / "units" / "degree_sum.py").write_text(DEGREE_UNIT)
    (bench / "limits" / "tinykron.quick_layout.json").write_text(
        (bench / "limits" / "graph500.fa2_full.json").read_text())
    (bench / "limits" / "tinykron.degrees.json").write_text(json.dumps(
        {"limits": {"units_differ": {"limit": 0}, "degree_gap": {"limit": 0}}}))
    (bench / "metrics" / "units.quick.py").write_text(METRIC.format(moves="fa2_layout_s"))
    (bench / "metrics" / "units.degrees.py").write_text(METRIC.format(moves="degrees_s"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinykron", "source": "test", "reduced": ["scale"],
                            "file": "bgvbench/configs/tinykron.json", "why": "test"})
    for mix_name in ("quick_layout", "degrees"):
        spec["workloads"].append({"name": f"tinykron.{mix_name}", "config": "tinykron",
                                  "traffic": mix_name, "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tinykron.quick_layout")
    spec["end_to_end"].append({"name": "degrees_s", "unit": "s", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tinykron.degrees"]})
    for name, moves, cell in (("units.quick", "fa2_layout_s", "tinykron.quick_layout"),
                              ("units.degrees", "degrees_s", "tinykron.degrees")):
        spec["per_layer"].append({"name": name, "unit": "count", "better": "higher",
                                  "source": "program_counter", "layer": "entry",
                                  "moves": moves, "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data

    disc = harness.Discovery(bench)
    for cell, metric, e2e in (("tinykron.quick_layout", "units.quick", "fa2_layout_s"),
                              ("tinykron.degrees", "units.degrees", "degrees_s")):
        assert [m["name"] for m in disc.per_layer(cell)] == [metric]
        out = harness.run_cell(cell, 3, 0.1, True, t0=time.perf_counter(), device="cpu",
                               disc=disc)
        assert out["correct"], out["compared"]
        assert out["metrics"][metric]["value"] == out["attempted"]
        out = harness.run_cell(cell, 3, 0.1, False, t0=time.perf_counter(), device="cpu",
                               disc=disc)
        assert set(out["metrics"]) == {e2e, "setup_s"}
