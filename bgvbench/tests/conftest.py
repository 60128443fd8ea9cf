import copy
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")
    import torch

    torch.set_num_threads(1)  # one math thread a test process, as a run has


@pytest.fixture
def card():
    """The CUDA device, or a skip where this host has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


TINY_SCALE = 11

# The picture unit, which no cell of BENCHMARK.json runs yet, on a small
# graph of planted communities (the port's own generator: SCoDA merges
# little on a Kronecker graph, whose mode degree is 1), with the paper's
# pipeline settings cut to a CPU test's size.
PICTURE_CELL = "tinypic.picture"
PICTURE_CONFIG = {
    "name": "tinypic",
    "graph": {"generator": "test_planted", "nodes": 3000, "communities": 30, "p_in": 0.04,
              "p_out": 0.0008},
    "pipeline": {"rounds": 4, "block_size": 1024, "cms_rows": 4, "cms_edges_per_col": 1000,
                 "cms_seed": 24301, "s_cap": 512, "max_super_edges": 2048,
                 "iterations": 100, "init": "random", "dtype": "float32",
                 "repulsion_k": 80.0, "gravity": 1.0, "jitter_tolerance": 1.0,
                 "width": 256, "height": 256, "chunk_size": 4096},
}
PICTURE_LIMITS = {"units_differ": 0, "labels": 0, "supergraph": 0, "sizes": 0, "groups": 0,
                  "image_px": 0, "modularity": 1e-6, "shape_gap": 6e-3}


def tiny_config(cfg: dict, iterations: int = 20) -> dict:
    """A configuration cut to a CPU test's size, its kinds of work kept."""
    cfg = copy.deepcopy(cfg)
    cfg["graph"]["scale"] = TINY_SCALE
    if "iterations" in cfg["pipeline"]:
        cfg["pipeline"]["iterations"] = iterations
    return cfg


@pytest.fixture
def tiny():
    """A ``Discovery`` of this folder whose configurations and mixes are cut
    to a CPU test's size, with the picture cell ``tinypic.picture`` beside
    BENCHMARK.json's cells."""
    from bgvbench import harness

    class Tiny(harness.Discovery):
        def __init__(self):
            super().__init__()
            self.spec = copy.deepcopy(self.spec)
            self.spec["workloads"].append({"name": PICTURE_CELL, "config": "tinypic",
                                           "traffic": "picture", "chips": 1})
            self.spec["end_to_end"].insert(0, {"name": "picture_s", "unit": "s",
                                               "workloads": [PICTURE_CELL]})

        def config(self, name):
            if name == "tinypic":
                return copy.deepcopy(PICTURE_CONFIG)
            return tiny_config(super().config(name))

        def mix(self, name):
            m = super().mix(name)
            if "iterations" in m:
                m["iterations"] = 30
            return m

        def generator(self, name):
            if name != "test_planted":
                return super().generator(name)
            from repro_torch.graph.generators import planted_partition

            return SimpleNamespace(
                nodes=lambda g: g["nodes"],
                generate=lambda g, seed: planted_partition(
                    g["nodes"], g["communities"], g["p_in"], g["p_out"], seed=seed)[0])

        def limits(self, cell):
            return dict(PICTURE_LIMITS) if cell == PICTURE_CELL else super().limits(cell)

    return Tiny()
