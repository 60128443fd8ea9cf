"""Supergraph aggregation, CMS community sizes and modularity: the port on
the CPU against the reference package. Superedges ``(a, b, w, n)`` and
supernode sizes are bitwise; modularity (a float32 sum in another order)
is within 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import cms as jax_cms  # noqa: E402
from repro.core.modularity import modularity as jax_modularity  # noqa: E402
from repro.core import scoda as jax_scoda  # noqa: E402
from repro.core import stream as jax_stream  # noqa: E402
from repro.core import supergraph as jax_sg  # noqa: E402
from repro.graph import utils as jax_utils  # noqa: E402

from repro_torch.convert import config_from_reference, state_from_numpy  # noqa: E402
from repro_torch.core import modularity, supergraph  # noqa: E402
from repro_torch.core import stream as t_stream  # noqa: E402
from repro_torch.graph.generators import planted_partition  # noqa: E402

N = 800


@pytest.fixture(scope="module")
def detected():
    edges, _ = planted_partition(N, 16, 0.06, 0.004, seed=2)
    d = jax_utils.mode_degree(edges, N)
    cfg = jax_scoda.ScodaConfig(degree_threshold=d, block_size=256)
    e_pad = jnp.asarray(jax_utils.pad_edges(edges, len(edges), N))
    labels, _ = jax_scoda.detect_communities(e_pad, N, cfg)
    deg = jax_utils.degrees(e_pad, N)
    return edges, np.array(labels), np.array(deg)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)


def _assert_sg_equal(got, want, msg=""):
    for f in ("edges", "weights", "sizes", "n_supernodes", "n_superedges", "labels"):
        _eq(getattr(got, f), getattr(want, f), f"{msg}: {f}")


@pytest.mark.parametrize("max_super_edges", [4096, 97])  # 97: capacity overflow
@pytest.mark.parametrize("agg_backend", ["merge", "lexsort"])
def test_build_supergraph_bitwise(detected, max_super_edges, agg_backend):
    edges, labels, deg = detected
    s_cap = 256
    jcms = jax_cms.CMSConfig(rows=4, cols=256)
    e_pad = jax_utils.pad_edges(edges, len(edges) + 5, N)
    want = jax_sg.build_supergraph(
        jnp.asarray(e_pad), jnp.asarray(labels), jnp.asarray(deg), N, s_cap,
        max_super_edges, jcms, agg_backend,
    )
    got = supergraph.build_supergraph(
        torch.as_tensor(e_pad), torch.as_tensor(labels), torch.as_tensor(deg), N,
        s_cap, max_super_edges, config_from_reference(jcms), agg_backend,
    )
    _assert_sg_equal(got, want, agg_backend)
    if max_super_edges < int(want.n_superedges):
        assert int(got.n_superedges) > max_super_edges  # counts past capacity


@pytest.mark.parametrize("max_super_edges", [4096, 150])
def test_merge_equals_lexsort_chunked(detected, max_super_edges):
    """The merge backend equals its lexsort oracle chunk by chunk — also past
    capacity, where both truncate the same sorted tail — and equals the
    reference's merge state after every chunk."""
    edges, labels, _ = detected
    s_cap = 256
    dense, _ = jax_scoda.dense_labels(jnp.asarray(labels), N)
    ext = np.concatenate([np.asarray(dense), [s_cap]]).astype(np.int32)
    st_m = st_l = supergraph.agg_init(s_cap, max_super_edges)
    st_j = jax_sg.agg_init(s_cap, max_super_edges)
    for i in range(0, len(edges), 700):
        chunk = edges[i:i + 700]
        st_j = jax_sg.agg_update(st_j, jnp.asarray(chunk), jnp.asarray(ext),
                                 s_cap, max_super_edges, "merge")
        st_m = supergraph.agg_update(st_m, torch.as_tensor(chunk),
                                     torch.as_tensor(ext), s_cap, max_super_edges)
        st_l = supergraph.agg_update(st_l, torch.as_tensor(chunk),
                                     torch.as_tensor(ext), s_cap, max_super_edges,
                                     "lexsort")
        for m, lx, j in zip(st_m, st_l, st_j):
            _eq(m, lx.numpy(), f"chunk {i}")
            _eq(m, j, f"chunk {i}")
    # Resuming from the reference's state (state_from_numpy) stays equal.
    ours = state_from_numpy("agg", tuple(np.asarray(x) for x in st_j))
    extra = edges[:300]
    want = jax_sg.agg_update(st_j, jnp.asarray(extra), jnp.asarray(ext), s_cap,
                             max_super_edges, "merge")
    got = supergraph.agg_update(ours, torch.as_tensor(extra), torch.as_tensor(ext),
                                s_cap, max_super_edges)
    for g, w in zip(got, want):
        _eq(g, w)


def test_all_invalid_chunk_is_a_noop(detected):
    edges, labels, _ = detected
    s_cap = 256
    dense, _ = jax_scoda.dense_labels(jnp.asarray(labels), N)
    ext = torch.as_tensor(np.concatenate([np.asarray(dense), [s_cap]]).astype(np.int32))
    st = supergraph.agg_update(supergraph.agg_init(s_cap, 512),
                               torch.as_tensor(edges[:500]), ext, s_cap, 512)
    trash = torch.full((64, 2), N, dtype=torch.int32)
    intra = torch.as_tensor(np.array([[u, u] for u in range(64)], np.int32))
    for chunk in (trash, intra):
        assert supergraph.agg_update(st, chunk, ext, s_cap, 512) is st


def test_stream_supergraph_chunked_equals_one_shot_and_reference(detected):
    edges, labels, deg = detected
    s_cap, mse = 256, 4096
    jcms = jax_cms.CMSConfig(rows=4, cols=300)
    js = jax_stream.EdgeChunkStream(edges, N, 512)
    want_sg, want_q = jax_stream.stream_supergraph(
        js, jnp.asarray(labels), jnp.asarray(deg), N, s_cap, mse, jcms
    )
    results = []
    for cs in (512, len(edges)):
        ts = t_stream.EdgeChunkStream(edges, N, cs)
        results.append(t_stream.stream_supergraph(
            ts, torch.as_tensor(labels), torch.as_tensor(deg), N, s_cap, mse,
            config_from_reference(jcms), device="cpu",
        ))
    for sg, q in results:
        _assert_sg_equal(sg, want_sg)
        assert abs(float(q) - float(want_q)) <= 1e-6
    # The one-shot modularity matches too.
    e_pad = jax_utils.pad_edges(edges, len(edges) + 3, N)
    q_j = jax_modularity(jnp.asarray(e_pad), jnp.asarray(labels), N)
    q_t = modularity.modularity(torch.as_tensor(e_pad), torch.as_tensor(labels), N)
    assert abs(float(q_t) - float(q_j)) <= 1e-6
