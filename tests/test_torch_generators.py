"""The port's graph generators (``repro_torch.graph``) bit for bit against
the reference's over a few sizes and seeds: both are numpy only, so the same
seed must draw the same edges."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.graph import generators as jgen  # noqa: E402

from repro_torch import graph  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402


def _same(got, want):
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n, m, seed", [(2, 4, 0), (10, 1, 3), (300, 4, 0), (1000, 6, 11)])
def test_powerlaw_graph_matches_reference(n, m, seed):
    got = gen.powerlaw_graph(n, m, seed=seed)
    _same(got, jgen.powerlaw_graph(n, m, seed=seed))
    assert (got[:, 0] != got[:, 1]).all()


@pytest.mark.parametrize("n, p, seed", [(1, 0.5, 0), (50, 0.0, 0), (40, 1.0, 2),
                                        (500, 0.01, 0), (2000, 0.002, 7)])
def test_erdos_renyi_matches_reference(n, p, seed):
    _same(gen.erdos_renyi(n, p, seed=seed), jgen.erdos_renyi(n, p, seed=seed))


@pytest.mark.parametrize("nx, ny", [(1, 1), (1, 7), (5, 3), (32, 32)])
def test_grid_mesh_matches_reference(nx, ny):
    got = gen.grid_mesh(nx, ny)
    _same(got, jgen.grid_mesh(nx, ny))
    assert len(got) == nx * (ny - 1) + (nx - 1) * ny


def test_graph_package_exports_the_generators():
    for name in ("planted_partition", "powerlaw_graph", "erdos_renyi", "grid_mesh"):
        assert getattr(graph, name) is getattr(gen, name)
    edges, labels = graph.planted_partition(200, 4, 0.1, 0.01, seed=1)
    want = jgen.planted_partition(200, 4, 0.1, 0.01, seed=1)
    _same(edges, want[0])
    assert labels.tobytes() == want[1].tobytes()
