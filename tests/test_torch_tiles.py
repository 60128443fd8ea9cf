"""The tile-pyramid service of the port on the CPU, against the reference
package's ``repro.serve.tiles`` over the same scene.

The port's result is given the reference's positions (its sizes, groups,
labels and supergraph are bitwise equal already, test_torch_pipeline.py),
so served pyramid tiles differ only by the float32 tone map: ±1 per
channel. Drill-down helpers and the synthetic trace are exact. A drill
tile is bitwise against the port's own direct composition on the CPU.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro  # noqa: E402
from repro.graph.utils import mode_degree  # noqa: E402
from repro.serve import tiles as jtiles  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.graph.generators import planted_partition  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.render import RenderConfig, render_arrays  # noqa: E402
from repro_torch.serve import tiles  # noqa: E402
from repro_torch.serve.tiles import (  # noqa: E402
    DrillSpec,
    TileCache,
    TileEngine,
    TilePyramid,
    TileRequest,
    TileSpec,
)

N, COMMUNITIES = 300, 6
TILE = dict(tile_size=64, depth=2, drill_iterations=5)


@pytest.fixture(scope="module")
def scene():
    edges, _ = planted_partition(N, COMMUNITIES, 0.3, 0.01, seed=1)
    cfg = repro.default_config(N, len(edges), mode_degree(edges, N),
                               iterations=10, s_cap=64, init="degree")
    want = repro.biggraphvis(edges, N, cfg)
    pcfg = config_from_reference(cfg)
    got = repro_torch.biggraphvis(edges, N, pcfg, device="cpu")
    got.positions = np.asarray(want.positions)  # the tone map is all that differs
    return edges, cfg, pcfg, want, got


@pytest.fixture(scope="module")
def pyramids(scene):
    edges, cfg, pcfg, want, got = scene
    ref = jtiles.TilePyramid(want, jtiles.TileConfig(**TILE), source=edges, bgv_cfg=cfg)
    port = TilePyramid(got, config_from_reference(ref.cfg), source=edges, bgv_cfg=pcfg)
    return ref, port


def _spec_key(spec):
    if isinstance(spec, (TileSpec, jtiles.TileSpec)):
        return ("tile", spec.level, spec.x, spec.y)
    return ("drill", spec.community)


# -- against the reference ----------------------------------------------------


def test_pyramid_addressing_matches_reference(pyramids):
    ref, port = pyramids
    assert port.device == torch.device("cpu")  # the result's device
    assert port.bounds == pytest.approx(ref.bounds, rel=0, abs=0)
    assert [_spec_key(s) for s in port.specs()] == [_spec_key(s) for s in ref.specs()]
    for s in port.specs():
        assert port.tile_viewport(s.level, s.x, s.y) == ref.tile_viewport(s.level, s.x, s.y)


def test_served_tiles_within_one_of_reference(pyramids):
    ref, port = pyramids
    jengine = jtiles.TileEngine(ref, cache_bytes=1 << 20, slots=4)
    engine = TileEngine(port, cache_bytes=1 << 20, slots=4)
    drawn = 0
    for spec in port.specs():
        got = engine.request(spec)
        want = np.asarray(jengine.request(jtiles.TileSpec(spec.level, spec.x, spec.y)))
        assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, (spec, diff.max())
        drawn += int((got != 255).any(axis=-1).sum())
    assert drawn > 0


def test_drill_helpers_bitwise_against_reference(scene, pyramids):
    edges, _, _, want, got = scene
    ref, port = pyramids
    np.testing.assert_array_equal(port.drillable_communities(),
                                  ref.drillable_communities())
    assert port.drillable_communities().dtype == np.int32
    assert len(port.drillable_communities()) >= 2
    for c in list(port.drillable_communities()) + [len(got.sizes) - 1]:
        sub, members = tiles.community_subgraph(edges, got.labels, int(c))
        jsub, jmembers = jtiles.community_subgraph(edges, want.labels, int(c))
        np.testing.assert_array_equal(sub, jsub)
        np.testing.assert_array_equal(members, jmembers)
        assert sub.dtype == jsub.dtype and members.dtype == jmembers.dtype


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_trace_equals_reference(pyramids, seed):
    ref, port = pyramids
    got = tiles.synthetic_trace(port, 300, seed=seed, drill_frac=0.2)
    want = jtiles.synthetic_trace(ref, 300, seed=seed, drill_frac=0.2)
    assert [_spec_key(s) for s in got] == [_spec_key(s) for s in want]
    assert any(isinstance(s, DrillSpec) for s in got)


def test_drill_from_the_default_init_matches_reference():
    """The default configuration ("random" init): the port's result and a
    drill's layout against the reference's. Positions within 1e-4·max|pos|
    (test_torch_pipeline.py), the rest bitwise; the reference's drill is its
    ``full_layout_colored`` as its ``_render_drill`` calls it."""
    edges, _ = planted_partition(N, COMMUNITIES, 0.3, 0.01, seed=1)
    cfg = repro.default_config(N, len(edges), mode_degree(edges, N), iterations=10,
                               s_cap=64)
    assert cfg.layout.init == "random"
    want = repro.biggraphvis(edges, N, cfg)
    pcfg = config_from_reference(cfg)
    got = repro_torch.biggraphvis(edges, N, pcfg, device="cpu")
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    scale = np.abs(want.positions).max()
    np.testing.assert_allclose(got.positions, want.positions, rtol=0, atol=1e-4 * scale)
    tcfg = jtiles.TileConfig(**TILE)
    port = TilePyramid(got, config_from_reference(tcfg), source=edges, bgv_cfg=pcfg)
    community = int(port.drillable_communities()[0])
    sub, members, pos, groups = port.drill_layout(community)
    jsub, jmembers = jtiles.community_subgraph(edges, want.labels, community)
    np.testing.assert_array_equal(sub, jsub)
    np.testing.assert_array_equal(members, jmembers)
    wpos, wgroups = repro.full_layout_colored(
        jsub, len(jmembers), cfg, iterations=tcfg.drill_iterations,
        stop_tolerance=tcfg.drill_stop_tolerance, min_iterations=tcfg.drill_min_iterations)
    np.testing.assert_array_equal(groups, np.asarray(wgroups))
    wpos = np.asarray(wpos)
    np.testing.assert_allclose(pos, wpos, rtol=0, atol=1e-4 * np.abs(wpos).max())


def test_error_tile_equals_reference():
    np.testing.assert_array_equal(tiles.error_tile(17), jtiles.error_tile(17))


# -- the port's own contracts -------------------------------------------------


def test_served_tile_bitwise_against_direct_render(pyramids):
    _, port = pyramids
    engine = TileEngine(port, cache_bytes=1 << 20, slots=4)
    res = port.result
    for spec in (TileSpec(0, 0, 0), TileSpec(1, 1, 0)):
        direct, _ = render_arrays(
            res.positions, np.sqrt(np.maximum(res.sizes, 0.0)), res.groups,
            res.supergraph.edges.numpy(), edge_weights=res.supergraph.weights.numpy(),
            cfg=port.render_config(spec), device="cpu",
        )
        np.testing.assert_array_equal(engine.request(spec), direct)
        np.testing.assert_array_equal(engine.request(spec), direct)  # a hit


def test_drill_tile_bitwise_against_direct_composition(scene, pyramids):
    """A drill tile equals an independently derived ``full_layout_colored``
    + fitted render of the community (member mask and id remap recomputed
    here)."""
    edges, _, pcfg, _, got = scene
    _, port = pyramids
    community = int(port.drillable_communities()[0])
    served = port.render_tile(DrillSpec(community))
    labels = np.asarray(got.labels)
    members = np.nonzero(labels == community)[0]
    inside = edges[(labels[edges[:, 0]] == community) & (labels[edges[:, 1]] == community)]
    remap = {int(v): i for i, v in enumerate(members)}
    sub = np.array([[remap[int(u)], remap[int(v)]] for u, v in inside], np.int32)
    pos, groups = repro_torch.full_layout_colored(sub, len(members), pcfg, iterations=5,
                                                  device="cpu")
    direct, _ = render_arrays(pos, np.full(len(members), 2.0, np.float32), groups, sub,
                              cfg=RenderConfig(width=64, height=64), device="cpu")
    np.testing.assert_array_equal(served, direct)
    sub2, members2, pos2, groups2 = port.drill_layout(community)
    np.testing.assert_array_equal(sub2, sub)
    np.testing.assert_array_equal(pos2, pos)
    np.testing.assert_array_equal(groups2, groups)


def test_drill_needs_source_and_rejects_empty_community(scene, pyramids):
    _, _, _, _, got = scene
    _, port = pyramids
    bare = TilePyramid(got, tiles.TileConfig(tile_size=64, depth=1))
    with pytest.raises(RuntimeError, match="source"):
        bare.render_tile(DrillSpec(0))
    assert len(bare.drillable_communities()) == 0
    labels = np.asarray(got.labels)
    empty = next(c for c in range(len(got.sizes)) if not np.any(labels == c))
    with pytest.raises(ValueError, match="nothing to drill"):
        port.render_tile(DrillSpec(empty))
    with pytest.raises(TypeError):
        port.render_tile("level0")
    with pytest.raises(ValueError):
        port.tile_viewport(1, 2, 0)


def test_rerender_builds_no_kernel(pyramids):
    _, port = pyramids
    for spec in port.specs():
        port.render_tile(spec)
    c0 = repro_torch.jit_compile_count()
    for spec in port.specs():
        port.render_tile(spec)
    port.render_tile(DrillSpec(int(port.drillable_communities()[0])))
    assert repro_torch.jit_compile_count() - c0 == 0


def _tile(fill=0):
    return np.full((2, 2), fill, np.uint8)  # 4 bytes


def test_cache_lru_accounting():
    cache = TileCache(capacity_bytes=8)  # room for two 4-byte tiles
    cache.put("a", _tile(1))
    cache.put("b", _tile(2))
    assert cache.get("a")[0, 0] == 1  # freshens "a": "b" is now LRU
    cache.put("c", _tile(3))  # evicts "b"
    assert cache.keys() == ["a", "c"]
    assert cache.get("b") is None
    assert (cache.hits, cache.misses, cache.evictions) == (1, 1, 1)
    assert cache.bytes == 8 and len(cache) == 2 and cache.hit_rate == 0.5
    cache.put("a", np.zeros((1, 2), np.uint8))  # replace: bytes follow
    assert cache.bytes == 6 and cache.evictions == 1
    assert "a" in cache and "z" not in cache and cache.hits == 1  # probes neutral
    zero = TileCache(capacity_bytes=0)
    zero.put("k", _tile())
    assert len(zero) == 0 and zero.bytes == 0 and zero.get("k") is None


def test_engine_slot_cap_and_duplicate_collapse(pyramids):
    _, port = pyramids
    engine = TileEngine(port, cache_bytes=1 << 20, slots=2)
    specs = [TileSpec(1, 0, 0), TileSpec(1, 0, 0), TileSpec(1, 1, 0), TileSpec(1, 0, 1)]
    reqs = [TileRequest(s) for s in specs]
    for r in reqs:
        assert engine.submit(r)
    assert engine.n_pending == 4
    done = engine.tick()
    assert len(done) == 3 and engine.rendered == 2 and engine.n_pending == 1
    assert engine.tick() and all(r.done and not r.hit for r in reqs)
    assert all(r.tile is not None and r.latency_s > 0 for r in reqs)
    hit = TileRequest(specs[0])
    engine.submit(hit)
    assert hit.done and hit.hit and engine.n_pending == 0
    assert engine.tick() == []
    assert REGISTRY.value("serve.cache_tiles") == 3
    with pytest.raises(ValueError):
        TileEngine(port, slots=0)
    with pytest.raises(ValueError):
        TileEngine(port, deadline_s=0)


def test_engine_warmup_fills_cache_and_is_idempotent(pyramids):
    _, port = pyramids
    engine = TileEngine(port, cache_bytes=1 << 20, slots=4)
    drills = port.drillable_communities()[:2]
    n = engine.warmup(drills=drills)
    assert n == len(list(port.specs())) + len(drills) == len(engine.cache)
    assert engine.warmup(drills=drills) == 0
    assert engine.cache.misses == 0


def test_failed_render_gives_uncached_error_tile(scene, pyramids):
    _, _, _, _, got = scene
    _, port = pyramids
    labels = np.asarray(got.labels)
    empty = next(c for c in range(len(got.sizes)) if not np.any(labels == c))
    engine = TileEngine(port, cache_bytes=1 << 20, slots=4)
    before = REGISTRY.value("errors.failed_tiles")
    good, bad = TileRequest(TileSpec(0, 0, 0)), TileRequest(DrillSpec(empty))
    engine.submit(good)
    engine.submit(bad)
    done = engine.tick()
    assert {id(r) for r in done} == {id(good), id(bad)}
    assert bad.failed and not good.failed and engine.failed == 1
    np.testing.assert_array_equal(bad.tile, tiles.error_tile(64))
    assert DrillSpec(empty) not in engine.cache and TileSpec(0, 0, 0) in engine.cache
    assert REGISTRY.value("errors.failed_tiles") == before + 1


def test_overdue_misses_are_shed(pyramids):
    _, port = pyramids
    engine = TileEngine(port, cache_bytes=1 << 20, slots=4, deadline_s=1e-3)
    before = REGISTRY.value("errors.shed_tiles")
    req = TileRequest(TileSpec(1, 1, 1))
    engine.submit(req)
    time.sleep(0.01)
    done = engine.tick()
    assert done == [req] and req.failed and engine.shed == 1 and engine.rendered == 0
    np.testing.assert_array_equal(req.tile, tiles.error_tile(64))
    assert TileSpec(1, 1, 1) not in engine.cache
    assert REGISTRY.value("errors.shed_tiles") == before + 1
