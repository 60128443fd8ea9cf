"""On a machine with a card: every cell of BENCHMARK.json runs once, short,
through the command itself, and its outputs are correct."""
import json
import subprocess
import sys

import pytest

from bgvbench import harness

CELLS = [w["name"] for w in harness.Discovery().spec["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "-m", "bgvbench.run", "--workload", cell,
                        "--seed", str(2**31 + 77), "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
