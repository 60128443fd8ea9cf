"""The dry-run cells and the data pieces on the CPU against the reference
package: the BigGraphVis step builder (``launch.steps.build_bgv_step``)
against the reference's, built on its single-device host mesh, and the
numpy data pieces (molecule batches, the neighbour sampler, the three
batch streams) bitwise for the same seeds.

Tolerances: the detect step's labels, degrees and sketch are integers (the
sketch holds integer-valued float32 sums below 2^24) and must be bitwise.
A layout step's positions agree within 1e-4·max|pos| and its forces within
1e-4·max|f|, as ``test_torch_fa2.py`` holds a step: the two packages'
repulsion and attraction sums add in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.configs.biggraphvis import BGVDryConfig as JBGVDryConfig  # noqa: E402
from repro.kernels.grid import ops as jgrid_ops  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_bgv_step as jbuild_bgv_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig, ShapeSpec  # noqa: E402
from repro_torch.configs.biggraphvis import BGVDryConfig  # noqa: E402
from repro_torch.kernels.grid import ops as grid_ops  # noqa: E402
from repro_torch.launch.steps import BuiltStep, build_bgv_step, build_step  # noqa: E402


def _bgv(kind, n, e, n_out=0, **model):
    spec = dict(n_nodes=n, n_edges=e, n_out=n_out)
    return (jbuild_bgv_step(JArchConfig("t", "bgv", "gnn", JBGVDryConfig(**model)),
                            JShapeSpec("t", kind, **spec), make_host_mesh()),
            build_bgv_step(ArchConfig("t", "bgv", "gnn", BGVDryConfig(**model)),
                           ShapeSpec("t", kind, **spec)))


def _same_abstract(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_bgv_detect_step_is_bitwise_the_reference():
    from repro_torch.graph import planted_partition

    n, e = 600, 4096
    jstep, step = _bgv("bgv_detect", n, e, n_out=128)
    _same_abstract(step.abstract_args, jstep.abstract_args)
    assert step.meta == jstep.meta
    real, _ = planted_partition(n, 12, 0.1, 0.002, seed=4)
    edges = np.full((e, 2), n, np.int32)
    edges[: min(len(real), e)] = real[:e]
    com = np.arange(n + 1, dtype=np.int32)
    deg = np.zeros(n + 1, np.int32)
    want = jstep.fn(jnp.asarray(com), jnp.asarray(deg), jnp.asarray(edges))
    got = step.fn(torch.as_tensor(com), torch.as_tensor(deg), torch.as_tensor(edges))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert len(np.unique(got[0].numpy())) < n  # communities formed


@pytest.mark.parametrize("repulsion", ["exact", "grid"])
def test_bgv_layout_cell_matches_reference_and_direct_step(repulsion):
    """Mirrors ``test_bgv_layout_cell_threads_grid_binning``: the grid cell
    takes (cell, order) from ``bin_and_sort``, is bitwise a direct
    ``fa2.step`` with the same binning, and agrees with the reference's
    cell."""
    from repro_torch.core import forceatlas2 as fa2

    n, e = 128, 256
    model = {} if repulsion == "exact" else dict(layout_repulsion="grid",
                                                 layout_grid_size=8, layout_grid_window=8)
    jstep, step = _bgv("bgv_layout", n, e, **model)
    _same_abstract(step.abstract_args, jstep.abstract_args)
    assert step.meta == jstep.meta
    rng = np.random.default_rng(3)
    pos = rng.uniform(-300, 300, (n, 2)).astype(np.float32)
    prev_f = np.zeros_like(pos)
    mass = rng.uniform(1, 4, n).astype(np.float32)
    radii = np.sqrt(mass)
    edges = rng.integers(0, n, (e, 2)).astype(np.int32)
    edges[-8:] = n  # trash-padded slots
    w = np.ones(e, np.float32)
    jargs = [jnp.asarray(x) for x in (pos, prev_f, mass, radii, edges, w)]
    targs = [torch.as_tensor(x) for x in (pos, prev_f, mass, radii, edges, w)]
    cfg = fa2.FA2Config(iterations=1, use_radii=True, repulsion=repulsion, grid_size=8,
                        grid_window=8)
    extra = {}
    if repulsion == "grid":
        jargs += list(jgrid_ops.bin_and_sort(jargs[0], 8))
        cell, order = grid_ops.bin_and_sort(targs[0], 8)
        np.testing.assert_array_equal(cell.numpy(), np.asarray(jargs[-2]))
        np.testing.assert_array_equal(order.numpy(), np.asarray(jargs[-1]))
        targs += [cell, order]
        extra = dict(cell=cell, order=order)
    want_pos, want_f = jstep.fn(*jargs)
    got_pos, got_f = step.fn(*targs)
    (d_pos, d_f, _), _ = fa2.step((targs[0], targs[1], torch.tensor(1.0)), targs[4],
                                  targs[5], targs[2], targs[3], cfg, n, **extra)
    assert torch.equal(got_pos, d_pos) and torch.equal(got_f, d_f)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_pos)).max())
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_f)).max())


def test_step_builders_cover_the_serving_cells_and_refuse_a_mesh():
    for name, cell in (("yi-6b", "prefill_32k"), ("yi-6b", "decode_32k"),
                       ("sasrec", "serve_p99"), ("sasrec", "retrieval_cand"),
                       ("biggraphvis", "detect_livejournal")):
        arch = get_config(name)
        built = build_step(arch, arch.shapes[cell])
        assert isinstance(built, BuiltStep) and built.meta["param_count" if name != "biggraphvis"
                                                           else "tokens"] > 0
        with pytest.raises(ValueError, match="mesh must be None"):
            build_step(arch, arch.shapes[cell], mesh=object())
    prefill = build_step(get_config("yi-6b"), get_config("yi-6b").shapes["prefill_32k"])
    assert prefill.abstract_args[0]["embed"].dtype == torch.bfloat16  # serving weights
    for name, cell in (("yi-6b", "train_4k"), ("sasrec", "train_batch"),
                       ("gin-tu", "molecule")):
        arch = get_config(name)
        built = build_step(arch, arch.shapes[cell])  # training cells (params, opt state, batch)
        assert len(built.abstract_args) == 3 and set(built.abstract_args[1]) == {"count", "mv"}
        with pytest.raises(ValueError, match="mesh must be None"):
            build_step(arch, arch.shapes[cell], mesh=object())
    train = build_step(get_config("yi-6b"), get_config("yi-6b").shapes["train_4k"])
    assert train.abstract_args[0]["embed"].dtype == torch.float32  # training weights


# ----------------------------------------------------------- data pieces
def test_batched_molecules_is_bitwise():
    from repro.graph.generators import batched_molecules as jbm

    from repro_torch.graph.generators import batched_molecules

    for seed in (0, 5):
        for got, want in zip(batched_molecules(6, 9, 14, 4, seed=seed), jbm(6, 9, 14, 4, seed=seed)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_neighbor_sampler_is_bitwise():
    from repro.graph.sampling import NeighborSampler as JSampler
    from repro.graph.utils import to_csr as jto_csr

    from repro_torch.graph import NeighborSampler, powerlaw_graph, to_csr

    edges = powerlaw_graph(400, 3, seed=2)
    indptr, indices = to_csr(edges, 400)
    for got, want in zip((indptr, indices), jto_csr(edges, 400)):
        np.testing.assert_array_equal(got, want)
    s = NeighborSampler(indptr, indices, (4, 2))
    js = JSampler(indptr, indices, (4, 2))
    assert s.max_capacity(16) == js.max_capacity(16)
    for seed in (0, 1):
        seeds = np.random.default_rng(seed).integers(0, 400, 20)
        a = s.sample(seeds, np.random.default_rng(seed))
        b = js.sample(seeds, np.random.default_rng(seed))
        for f in ("nodes", "edges", "seed_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)


def test_batch_streams_are_bitwise():
    from repro.data import pipeline as jpipe

    from repro_torch.data import pipeline

    cases = [
        ("LMStream", dict(vocab=100, batch=8, seq_len=16, seed=3), [(0, 8), (2, 3)]),
        ("SASRecStream", dict(n_items=50, batch=6, seq_len=10, seed=1), [(0, 6), (1, 2)]),
    ]
    for cls, kw, shards in cases:
        got_s, want_s = getattr(pipeline, cls)(**kw), getattr(jpipe, cls)(**kw)
        for step in (0, 4):
            for shard in [None] + shards:
                got, want = got_s.batch_at(step, shard), want_s.batch_at(step, shard)
                assert list(got) == list(want)
                for k in got:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    kw = dict(batch=4, n_nodes=7, n_edges=12, d_feat=3, n_classes=3, seed=2)
    for step in (0, 1):
        got = pipeline.MoleculeStream(**kw).batch_at(step)
        want = jpipe.MoleculeStream(**kw).batch_at(step)
        assert list(got) == list(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
