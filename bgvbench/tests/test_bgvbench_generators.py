import numpy as np

from bgvbench.gen import graph500

GRAPH = {"scale": 12, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19}


def test_graph500_is_deterministic_in_the_seed():
    a = graph500.generate(GRAPH, 2**31 + 3)
    b = graph500.generate(GRAPH, 2**31 + 3)
    c = graph500.generate(GRAPH, 2**31 + 4)
    assert a.dtype == np.int32 and a.shape[1] == 2
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_graph500_is_a_simple_graph_of_its_draws():
    n = graph500.nodes(GRAPH)
    assert n == 4096
    e = graph500.generate(GRAPH, 9)
    assert (e[:, 0] != e[:, 1]).all() and e.min() >= 0 and e.max() < n
    key = np.minimum(e[:, 0], e[:, 1]).astype(np.int64) * n + np.maximum(e[:, 0], e[:, 1])
    assert len(np.unique(key)) == len(e)
    # 16 draws a vertex, some of them self-loops or repeats
    assert 0.6 * 16 * n < len(e) < 16 * n


def test_graph500_degrees_are_the_initiators():
    """The initiator's skew: a heavy tail and many isolated vertices, the
    same on every seed up to a few percent."""
    n = graph500.nodes(GRAPH)
    stats = []
    for seed in (1, 2, 2**31 + 7):
        deg = np.bincount(graph500.generate(GRAPH, seed).reshape(-1), minlength=n)
        stats.append(((deg == 0).mean(), deg.max() / deg.mean()))
    for isolated, tail in stats:
        assert 0.1 < isolated < 0.5
        assert tail > 30
    assert np.ptp([s[0] for s in stats]) < 0.03


def test_graph500_draws_bits_by_the_initiator():
    """Without the relabelling, a source bit is 1 with probability C + D and
    a target bit with B + D."""
    rng = np.random.default_rng(0)
    m, ab = 400_000, 0.57 + 0.19
    ii = rng.random(m, dtype=np.float32) > np.float32(ab)
    jj = rng.random(m, dtype=np.float32) > np.where(ii, np.float32(0.19 / (1 - ab)),
                                                    np.float32(0.57 / ab))
    assert abs(ii.mean() - 0.24) < 0.005
    assert abs(jj.mean() - 0.24) < 0.005
    assert abs((ii & jj).mean() - 0.05) < 0.003
