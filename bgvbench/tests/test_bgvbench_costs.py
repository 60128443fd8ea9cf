import json
from pathlib import Path

import pytest

from bgvbench import costs, peaks


def test_k2_bound_at_the_main_paths_size():
    # 17 operations a pair with radii, n = 16,384: bound by operations
    assert peaks.bound_s(*costs.k2(16384, True)) * 1e3 == pytest.approx(0.0681, abs=5e-5)


def test_k5_bound_at_the_full_paths_size():
    # 13 operations a (node, cell) pair, n = 685,230, C = 4,096
    assert peaks.bound_s(*costs.k5(685230, 4096)) * 1e3 == pytest.approx(0.545, abs=5e-4)


def test_every_cell_runs_the_configured_chip_count_and_files_exist():
    root = Path(__file__).resolve().parents[2]
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (root / c["file"]).exists()
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert (root / "bgvbench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in spec["per_layer"]:
        assert (root / "bgvbench" / "metrics" / f"{m['name']}.py").exists()
