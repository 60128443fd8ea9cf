"""The whole slice: ``biggraphvis`` + ``render`` of the port on the CPU
against the reference package, on planted-partition graphs.

Bitwise: labels, sizes, color groups, the supergraph, n_supernodes and
n_superedges, and the raster int32 accumulators given the reference's pixel
coordinates. Within tolerance: modularity (1e-6, a float32 sum in another
order), positions (1e-4·max|pos| after a few iterations from the degree
init and from the default "random" one, see test_torch_fa2.py) and image pixels (±1 from the float32 tone
map). Disk-backed sources are held against the reference's in-memory run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro  # noqa: E402
from repro.core.stream import StreamConfig as JaxStreamConfig  # noqa: E402
from repro.graph.utils import mode_degree  # noqa: E402
from repro.render import raster as jax_raster  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import config_from_reference, state_from_numpy  # noqa: E402
from repro_torch.core.pipeline import layout_supergraph  # noqa: E402
from repro_torch.data import edge_store  # noqa: E402
from repro_torch.graph.generators import planted_partition  # noqa: E402
from repro_torch.render import raster  # noqa: E402
from repro_torch.render.png import read_png, write_png  # noqa: E402

CASES = {"ppart-300": (300, 6, 0.15, 0.01), "ppart-3000": (3000, 30, 0.04, 0.0008)}


@pytest.fixture(scope="module", params=[(case, init) for case in sorted(CASES)
                                        for init in ("degree", "random")],
                ids=lambda p: p[0] if p[1] == "degree" else "-".join(p))
def runs(request):
    """Each graph from the degree init and from the default configuration's
    "random" init (the reference's draw, bit for bit)."""
    case, init = request.param
    n, k, p_in, p_out = CASES[case]
    edges, _ = planted_partition(n, k, p_in, p_out, seed=0)
    cfg = repro.default_config(n, len(edges), mode_degree(edges, n),
                               iterations=4, init=init)
    scfg = JaxStreamConfig(chunk_size=2048)
    want = repro.biggraphvis(edges, n, cfg, scfg)
    got = repro_torch.biggraphvis(edges, n, config_from_reference(cfg),
                                  config_from_reference(scfg), device="cpu")
    return edges, n, cfg, want, got


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def test_biggraphvis_matches_reference(runs):
    _, _, _, want, got = runs
    assert got.n_supernodes == want.n_supernodes
    assert got.n_superedges == want.n_superedges
    _eq(got.labels, want.labels, "labels")
    _eq(got.sizes, want.sizes, "sizes")
    _eq(got.groups, want.groups, "groups")
    for f in ("edges", "weights", "sizes", "n_supernodes", "n_superedges", "labels"):
        _eq(getattr(got.supergraph, f), getattr(want.supergraph, f), f)
    assert abs(got.modularity - want.modularity) <= 1e-6
    scale = np.abs(want.positions).max()
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-4 * scale)
    assert got.timings["layout_iterations"] == want.timings["layout_iterations"]
    assert got.stream.chunks == want.stream.chunks
    assert got.stream.passes == want.stream.passes


def test_layout_of_the_reference_supergraph(runs):
    """The port's layout stage, fed the reference's supergraph through
    ``state_from_numpy``, lands on the reference's positions."""
    _, _, cfg, want, _ = runs
    sg = state_from_numpy("supergraph", want.supergraph)
    pos, iters = layout_supergraph(sg, config_from_reference(cfg), device="cpu")
    scale = np.abs(want.positions).max()
    np.testing.assert_allclose(pos.numpy(), want.positions, rtol=0, atol=1e-4 * scale)
    assert iters == want.timings["layout_iterations"]


def _pixel_inputs(result, hs, ws, margin=0.04):
    """The renderer's host-side pixel arithmetic, from one result."""
    pos = np.asarray(result.positions, np.float32)
    radii = np.sqrt(np.maximum(np.asarray(result.sizes, np.float32), 0.0))
    alive = radii > 0
    scale, ox, oy = jax_raster._fit_transform(pos[alive], ws, hs, margin)
    px = ((pos[:, 0] - ox) * scale + ws / 2.0).astype(np.float32)
    py = (hs / 2.0 - (pos[:, 1] - oy) * scale).astype(np.float32)
    r_px = np.where(alive, np.clip(radii * scale, 1.0, 0.125 * min(hs, ws)), 0.0)
    return px, py, r_px.astype(np.float32), np.asarray(result.groups, np.int32)


def test_raster_accumulators_bitwise_given_reference_pixels(runs):
    _, _, _, want, _ = runs
    hs, ws, g = 192, 256, 11
    px, py, r_px, groups = _pixel_inputs(want, hs, ws)
    r_px[:3] = [9.5, 30.0, 12.25]  # a few large disks take the dense kernel
    node_j = jax_raster._node_pass(px, py, r_px, groups, g, hs, ws, "ref")
    node_t = raster._node_pass(px, py, r_px, groups, g, hs, ws, torch.device("cpu"))
    _eq(node_t, node_j, "node pass")
    assert int(node_t.sum()) > 0

    sedges = np.array(want.supergraph.edges)
    winc = np.clip(np.round(np.asarray(want.supergraph.weights)), 1, 1 << 20)
    winc = winc.astype(np.int32)
    # The reference's compiler contracts some sample lerps pu + t·(pv − pu)
    # into a fused multiply-add, which moves about one sample in 10⁶ by a
    # pixel. On a 1/64-pixel grid every lerp is exact in float32, so the
    # sample pixels are those of the reference whichever way it rounds.
    px, py = np.round(px * 64) / 64, np.round(py * 64) / 64
    pxy = np.concatenate([np.stack([px, py], 1), [[0.0, 0.0]]]).astype(np.float32)
    gext = np.concatenate([groups, [0]]).astype(np.int32)
    for inc in (None, winc):
        acc_j = jax_raster._edge_splat_update(
            jnp.zeros(g * hs * ws, jnp.int32), jnp.asarray(sedges), jnp.asarray(pxy),
            jnp.asarray(gext), None if inc is None else jnp.asarray(inc),
            hs, ws, 8, g, "ref",
        )
        acc_t = torch.zeros(g * hs * ws, dtype=torch.int32)
        raster._edge_splat_update(
            acc_t, torch.as_tensor(sedges), torch.as_tensor(pxy),
            torch.as_tensor(gext), None if inc is None else torch.as_tensor(inc),
            hs, ws, 8, g,
        )
        _eq(acc_t, acc_j, "edge splat")
        assert int(acc_t.sum()) > 0


def test_render_image_and_png_round_trip(runs, tmp_path):
    _, _, _, want, got = runs
    rcfg = repro.RenderConfig(width=200, height=160, supersample=2)
    img_j, _ = want.render(None, cfg=rcfg)
    # Render the reference's own positions through the port, so the images
    # differ only by the float32 tone map.
    got.positions = np.asarray(want.positions)
    path = tmp_path / "port.png"
    img_t, stats = got.render(str(path), cfg=config_from_reference(rcfg))
    assert img_t.shape == (160, 200, 3) and img_t.dtype == np.uint8
    diff = np.abs(img_t.astype(np.int32) - np.asarray(img_j).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_array_equal(read_png(str(path)), img_t)
    assert stats.nodes_drawn == int((np.asarray(want.sizes) > 0).sum())
    frac, counts = raster.image_summary(img_t)
    assert frac >= 0.01 and (counts > 0).sum() >= 3
    assert "render_s" in got.timings


def test_disk_sources_match_reference_in_memory(runs, tmp_path):
    """Port runs from .npy / .bin / shard stores equal the reference's
    in-memory run (its own disk path is a known fault on this stack)."""
    edges, n, cfg, want, _ = runs
    srcs = [
        edge_store.write_npy(tmp_path / "e.npy", edges),
        edge_store.write_bin(tmp_path / "e.bin", edges),
        str(tmp_path / "shards"),
    ]
    edge_store.write_shards(tmp_path / "shards", edges, shard_edges=len(edges) // 3 + 1)
    tcfg = config_from_reference(cfg)
    for src in srcs:
        got = repro_torch.biggraphvis(
            src, n, tcfg, repro_torch.StreamConfig(chunk_size=1024), device="cpu"
        )
        _eq(got.labels, want.labels, str(src))
        _eq(got.supergraph.edges, want.supergraph.edges, str(src))
        _eq(got.supergraph.weights, want.supergraph.weights, str(src))


def test_write_png_rejects_bad_images(tmp_path):
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))


# A bfloat16 layout (``layout.dtype="bfloat16"``): the reference returns an
# ml_dtypes bfloat16 ``positions`` array, the port float32 holding the same
# kind of values (numpy has no bfloat16 where the port runs). Within
# 2^-7·max|pos| (test_torch_fa2.py states why); every integer output
# bitwise.
@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("init", ["degree", "random"])
def test_bfloat16_biggraphvis_matches_reference(iterations, init, tmp_path):
    import dataclasses

    n, k, p_in, p_out = CASES["ppart-300"]
    edges, _ = planted_partition(n, k, p_in, p_out, seed=0)
    cfg = repro.default_config(n, len(edges), mode_degree(edges, n),
                               iterations=iterations, init=init)
    cfg = dataclasses.replace(cfg, layout=dataclasses.replace(cfg.layout, dtype="bfloat16"))
    scfg = JaxStreamConfig(chunk_size=2048)
    want = repro.biggraphvis(edges, n, cfg, scfg)
    tcfg = config_from_reference(cfg)
    got = repro_torch.biggraphvis(edges, n, tcfg, config_from_reference(scfg), device="cpu")
    assert got.n_supernodes == want.n_supernodes
    assert got.n_superedges == want.n_superedges
    _eq(got.labels, want.labels, "labels")
    _eq(got.sizes, want.sizes, "sizes")
    _eq(got.groups, want.groups, "groups")
    for f in ("edges", "weights", "sizes", "n_supernodes", "n_superedges", "labels"):
        _eq(getattr(got.supergraph, f), getattr(want.supergraph, f), f)
    assert abs(got.modularity - want.modularity) <= 1e-6
    assert np.asarray(want.positions).dtype == jnp.bfloat16
    assert got.positions.dtype == np.float32
    wpos = np.asarray(want.positions).astype(np.float32)
    scale = np.abs(wpos).max()
    np.testing.assert_allclose(got.positions, wpos, rtol=0, atol=2.0**-7 * scale)

    # The layout's bfloat16 tensor widened to float32 is what the result
    # holds, and ``render`` draws exactly those positions.
    pos, _ = layout_supergraph(got.supergraph, tcfg, device="cpu")
    assert pos.dtype == torch.bfloat16
    widened = pos.to(torch.float32).numpy()
    np.testing.assert_array_equal(got.positions.view(np.uint32), widened.view(np.uint32))
    rcfg = repro.RenderConfig(width=200, height=160, supersample=2)
    img, stats = got.render(str(tmp_path / "bf16.png"), cfg=config_from_reference(rcfg))
    direct, _ = raster.render_arrays(
        widened, np.sqrt(np.maximum(got.sizes, 0.0)), got.groups, got.supergraph.edges.numpy(),
        edge_weights=got.supergraph.weights.numpy(), cfg=config_from_reference(rcfg),
        device="cpu")
    np.testing.assert_array_equal(img, direct)
    np.testing.assert_array_equal(read_png(str(tmp_path / "bf16.png")), img)
    assert stats.nodes_drawn == int((np.asarray(want.sizes) > 0).sum())
