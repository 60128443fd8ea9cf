"""SCoDA community detection, dense relabelling, the count–min sketch and
graph degrees: the port on the CPU against the reference package, bitwise.
Inputs are planted-partition graphs and keys made with numpy from a seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cms as jax_cms  # noqa: E402
from repro.core import scoda as jax_scoda  # noqa: E402
from repro.core import stream as jax_stream  # noqa: E402
from repro.graph import utils as jax_utils  # noqa: E402

from repro_torch.convert import config_from_reference, state_from_numpy  # noqa: E402
from repro_torch.core import cms, scoda  # noqa: E402
from repro_torch.core import stream as t_stream  # noqa: E402
from repro_torch.graph import utils  # noqa: E402
from repro_torch.graph.generators import planted_partition  # noqa: E402

N = 600


@pytest.fixture(scope="module")
def graph():
    edges, _ = planted_partition(N, 12, 0.08, 0.003, seed=1)
    return edges


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


@pytest.mark.parametrize("knobs", [
    {},
    {"conflict": "min"},
    {"degree_update": "paper", "tie_break": "join"},
    {"exact_block_degrees": False, "propagate_jumps": 2},
    {"threshold_schedule": "geometric", "compress_labels": True, "block_size": 64},
])
def test_detect_communities_bitwise(graph, knobs):
    d = jax_utils.mode_degree(graph, N)
    jcfg = jax_scoda.ScodaConfig(degree_threshold=d, **{"block_size": 256, **knobs})
    e_pad = jax_utils.pad_edges(graph, len(graph) + 13, N)
    want_l, want_d = jax_scoda.detect_communities(jnp.asarray(e_pad), N, jcfg)
    tcfg = config_from_reference(jcfg)
    assert tcfg == scoda.ScodaConfig(**dataclasses.asdict(jcfg))
    got_l, got_d = scoda.detect_communities(torch.as_tensor(e_pad), N, tcfg)
    _eq(got_l, want_l, str(knobs))
    _eq(got_d, want_d, str(knobs))
    dense, n_c = scoda.dense_labels(got_l, N)
    wdense, wn_c = jax_scoda.dense_labels(want_l, N)
    _eq(dense, wdense)
    assert int(n_c) == int(wn_c)


@pytest.mark.parametrize("chunk_size", [None, 512, 1000])
def test_stream_detect_chunked_bitwise(graph, chunk_size):
    """1-chunk and multi-chunk streams (1000 rounds up to a block multiple)
    give the reference's labels, SCoDA degrees and graph degrees; chunked
    equals one-shot."""
    d = jax_utils.mode_degree(graph, N)
    jcfg = jax_scoda.ScodaConfig(degree_threshold=d, block_size=256)
    cs = chunk_size or len(graph)
    js = jax_stream.EdgeChunkStream(graph, N, cs, block_size=256)
    want = jax_stream.stream_detect(js, N, jcfg)
    ts = t_stream.EdgeChunkStream(graph, N, cs, block_size=256)
    got = t_stream.stream_detect(ts, N, config_from_reference(jcfg), device="cpu")
    assert ts.chunk_size == js.chunk_size and ts.n_chunks == js.n_chunks
    for g, w in zip(got, want):
        _eq(g, w, f"chunk_size={chunk_size}")
    one_l, _ = scoda.detect_communities(
        torch.as_tensor(utils.pad_edges(graph, len(graph), N)), N,
        config_from_reference(jcfg),
    )
    _eq(got[0], one_l.numpy())


def test_scoda_update_from_reference_state(graph):
    """A chunk update resumed from the reference's state (state_from_numpy)
    lands on the reference's next state."""
    d = jax_utils.mode_degree(graph, N)
    jcfg = jax_scoda.ScodaConfig(degree_threshold=d, block_size=128)
    first, second = graph[:1024], graph[1024:2048]
    st = jax_scoda.scoda_update(jax_scoda.scoda_init(N), jnp.asarray(first), 19, jcfg)
    ours = state_from_numpy("scoda", (np.asarray(st[0]), np.asarray(st[1])))
    want = jax_scoda.scoda_update(st, jnp.asarray(second), 19, jcfg)
    got = scoda.scoda_update(ours, torch.as_tensor(second), 19,
                             config_from_reference(jcfg))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("rows,cols,seed", [(4, 256, 0x5EED), (3, 1013, 7), (5, 64, 123)])
def test_cms_update_query_bitwise(rows, cols, seed):
    rng = np.random.default_rng(cols)
    keys = rng.integers(-3, 5000, 3000).astype(np.int32)  # negatives are padding
    keys[:4] = [0, 2**31 - 1, -1, 65535]
    w = rng.integers(0, 50, 3000).astype(np.float32)
    jcfg = jax_cms.CMSConfig(rows=rows, cols=cols, seed=seed)
    tcfg = config_from_reference(jcfg)
    a_j, b_j = jax_cms.hash_params(jcfg)
    a_t, b_t = cms.hash_params(tcfg)
    np.testing.assert_array_equal(np.asarray(a_j), a_t)
    np.testing.assert_array_equal(np.asarray(b_j), b_t)
    _eq(cms.hash_keys(torch.as_tensor(keys), a_t, b_t, cols),
        jax_cms.hash_keys(jnp.asarray(keys), a_j, b_j, cols))
    sk_j = jax_cms.update(jax_cms.init_sketch(jcfg), jnp.asarray(keys), jnp.asarray(w), jcfg)
    sk_t = cms.update(cms.init_sketch(tcfg), torch.as_tensor(keys), torch.as_tensor(w), tcfg)
    _eq(sk_t, sk_j)
    q = rng.integers(0, 6000, 500).astype(np.int32)
    _eq(cms.query(sk_t, torch.as_tensor(q), tcfg),
        jax_cms.query(sk_j, jnp.asarray(q), jcfg))
    _eq(cms.merge(sk_t, sk_t, sk_t), jax_cms.merge(sk_j, sk_j, sk_j))


def test_graph_degrees_and_mode_degree(graph):
    e_pad = jax_utils.pad_edges(graph, len(graph) + 7, N)
    _eq(utils.degrees(torch.as_tensor(e_pad), N),
        jax_utils.degrees(jnp.asarray(e_pad), N))
    assert utils.mode_degree(graph, N) == jax_utils.mode_degree(graph, N)
    np.testing.assert_array_equal(utils.pad_edges(graph, len(graph) + 7, N), e_pad)
