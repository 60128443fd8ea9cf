"""The result line's keys, and the refusal to run without a card."""
import json
import os
import subprocess
import sys
import time

import pytest

from bgvbench import harness
from conftest import PICTURE_CELL

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", ["graph500.fa2_full", PICTURE_CELL])
@pytest.mark.parametrize("trace", [False, True])
def test_result_has_the_contract_keys(tiny, cell, trace):
    out = harness.run_cell(cell, 2**31 + 9, 0.1, trace, t0=time.perf_counter(),
                           device="cpu", disc=tiny)
    keys = set(out) - {"breakdown"} if trace else set(out)
    assert keys == KEYS | {"compared"}
    assert list(out)[-1] == "compared"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = {m["name"] for m in tiny.end_to_end(cell)}
        assert set(out["metrics"]) == e2e
    assert out["correct"], out["compared"]
    json.dumps(out)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-m", "bgvbench.run", "--workload",
                        "graph500.fa2_full", "--seed", "1", "--seconds", "1"],
                       cwd=harness.ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr

