"""Interactive tile-pyramid layout service over a computed ``BGVResult``.

The batch pipeline ends at one PNG; exploring a massive graph needs pan
and zoom. This module turns a finished layout into a cacheable surface:

* ``TilePyramid`` — multi-resolution tile addressing over the supergraph
  drawing. The alive supernodes' square world bounding box is level 0
  (one tile); level ``z`` splits it into ``2^z × 2^z`` tiles, each
  rendered through the streaming rasterizer (``repro_torch.render``) with
  a fixed ``RenderConfig.viewport``, so adjacent tiles clip splats at the
  shared pixel edge and tile the scene seamlessly. Tiles and drills run on
  the device the result was computed on, through the rasterizer's kernels
  (K3's two entries, K4).
* **drill-down** (GMine's hierarchical model) — a ``DrillSpec(community)``
  request expands one community's *internal* structure: the induced
  subgraph of its member nodes is laid out and recolored by
  ``full_layout_colored`` (sub-communities re-detected inside the
  community; SCoDA, K1, K8, then K2, or K5–K7 above 4,096 members) and
  rendered to a fixed-size tile.
* ``TileEngine`` — the serving loop: requests are served from a
  byte-capped LRU ``TileCache`` on hit, and queued misses are rendered in
  slot-capped batches per ``tick()``.
* ``synthetic_trace`` — the zipfian pan/zoom traffic model of
  ``launch/serve.py``; the same seed draws the same trace as the
  reference package's.

Contract. A served pyramid tile equals, bit for bit, a direct one-shot
``render_arrays`` of the same viewport on the same device: the renderer's
integer accumulators make a render deterministic given the positions. A
served drill tile equals a direct ``full_layout_colored`` + fitted render
of the same community on the CPU. On the card a drill is the same bits
from run to run (the attraction sums in a fixed order, kernel K7), but
not the CPU's: the repulsion kernels round differently from their plain
versions, and FA2's speed controller amplifies that over a drill's 60
iterations. There a drill holds its groups bitwise against the CPU, its
positions within 1e-4·max|pos| of the CPU's after 4 iterations, and its
layout quality after 60 (``chip_smoke.py``, phase serve).

The service compiles nothing at steady state: ``jit_compile_count`` counts
kernel builds and library loads, which happen once per process.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.pipeline import BGVConfig, BGVResult, full_layout_colored
from repro_torch.data.edge_store import as_edge_store
from repro_torch.device import host_array, resolve_device
from repro_torch.obs.meters import jit_compile_count  # noqa: F401  (public surface)
from repro_torch.obs.metrics import REGISTRY, ensure_error_counters
from repro_torch.obs.trace import get_tracer
from repro_torch.render.raster import RenderConfig, render_arrays

# ---------------------------------------------------------------------------
# Tile addressing


@dataclass(frozen=True)
class TileSpec:
    """Pyramid tile address: ``level`` ∈ [0, depth), ``x``/``y`` ∈
    [0, 2^level) with ``y`` counted from the top (max world y) row."""

    level: int
    x: int
    y: int


@dataclass(frozen=True)
class DrillSpec:
    """Drill-down tile address: one community's internal layout."""

    community: int


@dataclass(frozen=True)
class TileConfig:
    """Pyramid/tile knobs. ``tile_size`` is the square output resolution
    per tile; ``depth`` is the number of pyramid levels (level 0 ..
    depth-1); ``margin`` pads the world bounding box so boundary disks
    aren't cut at level 0. ``supersample``/``edge_samples`` pass through to
    ``RenderConfig`` (the device picks the kernels, so there is no backend
    knob). ``drill_iterations`` is the FA2 iteration *cap* of a
    drill-down's internal layout and ``drill_node_radius`` its (world-unit)
    dot size; ``drill_stop_tolerance``/``drill_min_iterations`` enable
    FA2's adaptive stop for drill layouts (tolerance 0 keeps the fixed
    iteration count)."""

    tile_size: int = 256
    depth: int = 3
    margin: float = 0.05
    supersample: int = 1
    edge_samples: int = 8
    drill_iterations: int = 60
    drill_node_radius: float = 2.0
    drill_stop_tolerance: float = 0.0
    drill_min_iterations: int = 0


# ---------------------------------------------------------------------------
# LRU tile cache


class TileCache:
    """Byte-capped LRU cache of rendered tiles.

    ``get`` counts a hit (and freshens recency) or a miss; ``put``
    inserts/replaces and evicts least-recently-used entries until the
    byte total fits ``capacity_bytes`` (a tile larger than the whole
    capacity is dropped immediately — capacity 0 caches nothing).
    Accounting: ``hits``/``misses``/``evictions``/``bytes``.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:  # stats-neutral membership probe
        return key in self._entries

    def keys(self):
        """Keys in eviction order (least recently used first)."""
        return list(self._entries)

    def get(self, key):
        tile = self._entries.get(key)
        if tile is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return tile

    def put(self, key, tile: np.ndarray) -> None:
        if key in self._entries:
            self.bytes -= self._entries[key].nbytes
            del self._entries[key]
        self._entries[key] = tile
        self.bytes += tile.nbytes
        while self.bytes > self.capacity_bytes and self._entries:
            _, evicted = self._entries.popitem(last=False)
            self.bytes -= evicted.nbytes
            self.evictions += 1

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


# ---------------------------------------------------------------------------
# Drill-down helpers (pure numpy)


def community_members(labels: np.ndarray, community: int) -> np.ndarray:
    """Node ids whose dense community label equals ``community``."""
    return np.nonzero(np.asarray(labels) == community)[0].astype(np.int32)


def community_subgraph(
    edges: np.ndarray, labels: np.ndarray, community: int
) -> tuple[np.ndarray, np.ndarray]:
    """Induced internal subgraph of one community.

    Returns ``(sub_edges [k, 2] int32, members [m] int32)`` with edge
    endpoints remapped to member-local ids ``[0, m)`` preserving member
    order — the input to a drill-down ``full_layout_colored``.
    """
    edges = np.asarray(edges)
    labels = np.asarray(labels)
    members = community_members(labels, community)
    internal = (labels[edges[:, 0]] == community) & (
        labels[edges[:, 1]] == community
    )
    remap = np.full(len(labels), -1, np.int32)
    remap[members] = np.arange(len(members), dtype=np.int32)
    return remap[edges[internal]], members


def _host(x) -> np.ndarray:
    """A host array of ``x`` (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        return host_array(x)
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Tile pyramid


class TilePyramid:
    """Multi-resolution tile addressing + rendering over a ``BGVResult``.

    ``source`` (any ``repro_torch.data.edge_store`` edge source) and
    ``bgv_cfg`` enable drill-down tiles; without them only pyramid
    (supergraph) tiles are renderable. The supergraph scene arrays are
    materialized on the host once at construction, so every
    ``render_tile`` call reuses identical arrays. ``device`` (None: the
    device ``result`` was computed on) is where tiles and drills run.
    """

    def __init__(
        self,
        result: BGVResult,
        cfg: TileConfig | None = None,
        *,
        source=None,
        bgv_cfg: BGVConfig | None = None,
        device=None,
    ):
        self.result = result
        self.cfg = cfg or TileConfig()
        self.device = resolve_device(device if device is not None else result.device)
        sizes = np.maximum(_host(result.sizes).astype(np.float32), 0.0)
        self._radii = np.sqrt(sizes)  # paper §4.1: radius ∝ √size
        self._positions = _host(result.positions).astype(np.float32)
        self._groups = _host(result.groups).astype(np.int32)
        self._labels = _host(result.labels)
        sg = result.supergraph
        self._sg_edges = None if sg is None else _host(sg.edges)
        self._sg_weights = None if sg is None else _host(sg.weights)
        self.bounds = self._square_bounds()
        self.bgv_cfg = bgv_cfg
        self._edges_np = None
        if source is not None:
            store = as_edge_store(source)
            self._edges_np = np.asarray(store.read(0, store.n_edges))
        self._drillable = None

    def _square_bounds(self) -> tuple[float, float, float, float]:
        """Square world bbox of the alive supernodes, padded by ``margin``
        per side — the level-0 viewport every level subdivides."""
        alive = self._radii > 0
        p = self._positions[alive] if alive.any() else self._positions
        lo = p.min(axis=0).astype(np.float64)
        hi = p.max(axis=0).astype(np.float64)
        cx, cy = (lo + hi) / 2.0
        half = float(max(np.max(hi - lo) / 2.0, 1e-6))
        half *= 1.0 + 2.0 * self.cfg.margin
        return (cx - half, cy - half, cx + half, cy + half)

    # -- addressing ---------------------------------------------------------

    @staticmethod
    def n_tiles(level: int) -> int:
        """Tiles per axis at ``level`` (the level is ``n × n`` tiles)."""
        return 1 << level

    def specs(self, levels=None):
        """Every ``TileSpec`` of the given levels (default: all
        ``cfg.depth`` levels), level-major."""
        for level in levels if levels is not None else range(self.cfg.depth):
            n = self.n_tiles(level)
            for y in range(n):
                for x in range(n):
                    yield TileSpec(level, x, y)

    def tile_viewport(self, level: int, x: int, y: int):
        """World rect ``(x0, y0, x1, y1)`` of tile ``(level, x, y)``;
        ``y`` counts from the top row (world y-up, raster y-down)."""
        n = self.n_tiles(level)
        if not (0 <= x < n and 0 <= y < n):
            raise ValueError(f"tile ({x}, {y}) outside level {level} (n={n})")
        bx0, by0, _bx1, by1 = self.bounds
        w = (self.bounds[2] - bx0) / n
        return (bx0 + x * w, by1 - (y + 1) * w, bx0 + (x + 1) * w, by1 - y * w)

    # -- rendering ----------------------------------------------------------

    def render_config(self, spec: TileSpec) -> RenderConfig:
        """The exact ``RenderConfig`` a direct one-shot ``render_arrays``
        of this tile's viewport would use — the bit-identity oracle."""
        c = self.cfg
        return RenderConfig(
            width=c.tile_size,
            height=c.tile_size,
            supersample=c.supersample,
            edge_samples=c.edge_samples,
            viewport=self.tile_viewport(spec.level, spec.x, spec.y),
        )

    def render_tile(self, spec) -> np.ndarray:
        """Render one tile (pyramid or drill) → [tile, tile, 3] uint8."""
        if isinstance(spec, TileSpec):
            with get_tracer().span(
                "serve.render_tile", level=spec.level, x=spec.x, y=spec.y
            ):
                img, _ = render_arrays(
                    self._positions,
                    self._radii,
                    self._groups,
                    self._sg_edges,
                    edge_weights=self._sg_weights,
                    cfg=self.render_config(spec),
                    device=self.device,
                )
            return img
        if isinstance(spec, DrillSpec):
            with get_tracer().span(
                "serve.render_drill", community=spec.community
            ):
                return self._render_drill(spec.community)
        raise TypeError(f"unknown tile spec {spec!r}")

    def drill_layout(self, community: int):
        """A drill-down's inputs and layout: ``(sub_edges, members, pos,
        groups)`` of ``full_layout_colored`` on the community's internal
        subgraph, on ``self.device``."""
        if self._edges_np is None or self.bgv_cfg is None:
            raise RuntimeError(
                "drill-down needs TilePyramid(source=..., bgv_cfg=...): the "
                "supergraph result alone has no member edges to expand"
            )
        with get_tracer().span("serve.drill_subgraph", community=community):
            sub_edges, members = community_subgraph(
                self._edges_np, self._labels, community
            )
        if len(members) < 2 or len(sub_edges) == 0:
            raise ValueError(
                f"community {community} has {len(members)} members and "
                f"{len(sub_edges)} internal edges — nothing to drill into"
            )
        c = self.cfg
        pos, groups = full_layout_colored(
            sub_edges, len(members), self.bgv_cfg,
            iterations=c.drill_iterations,
            stop_tolerance=c.drill_stop_tolerance,
            min_iterations=c.drill_min_iterations,
            device=self.device,
        )
        return sub_edges, members, pos, groups

    def _render_drill(self, community: int) -> np.ndarray:
        """GMine-style drill-down: lay out + recolor the community's
        internal subgraph (``full_layout_colored`` re-runs detection inside
        it) and render to a fitted fixed-size tile."""
        sub_edges, members, pos, groups = self.drill_layout(community)
        c = self.cfg
        img, _ = render_arrays(
            pos,
            np.full(len(members), c.drill_node_radius, np.float32),
            groups,
            sub_edges,
            cfg=RenderConfig(
                width=c.tile_size,
                height=c.tile_size,
                supersample=c.supersample,
                edge_samples=c.edge_samples,
            ),
            device=self.device,
        )
        return img

    def drillable_communities(self, min_members: int = 2) -> np.ndarray:
        """Community ids with ≥ ``min_members`` members and ≥ 1 internal
        edge, largest first — the valid ``DrillSpec`` targets."""
        if self._edges_np is None:
            return np.empty(0, np.int32)
        if self._drillable is None:
            labels = self._labels
            s = len(self.result.sizes)
            counts = np.bincount(labels[labels >= 0], minlength=s)[:s]
            lu = labels[self._edges_np[:, 0]]
            lv = labels[self._edges_np[:, 1]]
            internal = np.bincount(
                lu[(lu == lv) & (lu >= 0)], minlength=s
            )[:s]
            ids = np.nonzero((counts >= max(min_members, 2)) & (internal > 0))[0]
            self._drillable = ids[np.argsort(-counts[ids], kind="stable")]
        return self._drillable.astype(np.int32)


# ---------------------------------------------------------------------------
# Serving engine


def error_tile(size: int) -> np.ndarray:
    """The degraded-service tile: a dark field with a bright diagonal
    cross — visually unmistakable, never cached, returned when a render
    fails or a queued miss is shed past the deadline (a bad tile must not
    take down the service or poison the cache)."""
    img = np.zeros((size, size, 3), np.uint8)
    img[..., 0] = 40
    d = np.arange(size)
    img[d, d] = (255, 64, 64)
    img[d, size - 1 - d] = (255, 64, 64)
    return img


@dataclass
class TileRequest:
    """One pan/zoom request: a tile address in, a rendered tile out.
    ``hit`` records whether the cache served it without a render;
    ``latency_s`` is submit → completion; ``failed`` marks a degraded
    completion (error tile from a failed render or a shed request)."""

    spec: TileSpec | DrillSpec
    tile: np.ndarray | None = None
    done: bool = False
    hit: bool = False
    failed: bool = False
    latency_s: float = 0.0
    _t0: float = field(default=0.0, repr=False)


class TileEngine:
    """Pan/zoom tile server: LRU cache in front of slot-batched re-renders.

    ``submit`` attaches a request (cache hits complete immediately),
    ``tick`` takes up to ``slots`` *distinct* queued tile addresses,
    renders them and completes all requests waiting on those tiles
    (duplicates collapse into one render).
    """

    def __init__(self, pyramid: TilePyramid, cache_bytes: int = 256 << 20,
                 slots: int = 8, deadline_s: float | None = None):
        if slots < 1:
            raise ValueError(f"slots must be positive, got {slots}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {deadline_s}")
        self.pyramid = pyramid
        self.cache = TileCache(cache_bytes)
        self.slots = slots
        self.deadline_s = deadline_s
        self._pending: deque[TileRequest] = deque()
        self.ticks = 0
        self.served = 0
        self.rendered = 0
        self.failed = 0
        self.shed = 0
        self.render_s = 0.0
        ensure_error_counters()

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def _complete(self, req: TileRequest, tile: np.ndarray, hit: bool,
                  failed: bool = False) -> None:
        req.tile = tile
        req.hit = hit
        req.failed = failed
        req.done = True
        req.latency_s = time.perf_counter() - req._t0
        self.served += 1
        REGISTRY.histogram("serve.latency_s").record(req.latency_s)
        if not hit:
            REGISTRY.histogram("serve.miss_latency_s").record(req.latency_s)

    def submit(self, req: TileRequest) -> bool:
        """Attach a request. Cache hits complete before returning; misses
        queue for the next ``tick``. Always accepts (returns True — the
        slot cap bounds per-tick render work, not the backlog)."""
        REGISTRY.counter("serve.requests").inc()
        req._t0 = time.perf_counter()
        tile = self.cache.get(req.spec)
        if tile is not None:
            self._complete(req, tile, hit=True)
        else:
            self._pending.append(req)
        return True

    def publish_cache_metrics(self, registry=None) -> None:
        """Mirror the LRU cache accounting into ``serve.cache_*`` gauges
        (last-value snapshots; called per tick and safe to call anytime)."""
        reg = registry if registry is not None else REGISTRY
        reg.gauge("serve.cache_bytes").set(self.cache.bytes)
        reg.gauge("serve.cache_tiles").set(len(self.cache))
        reg.gauge("serve.cache_hits").set(self.cache.hits)
        reg.gauge("serve.cache_misses").set(self.cache.misses)
        reg.gauge("serve.cache_evictions").set(self.cache.evictions)
        reg.gauge("serve.cache_hit_rate").set(self.cache.hit_rate)

    def _shed_overdue(self, done: list[TileRequest]) -> None:
        """Load-shed queued misses older than ``deadline_s``: complete
        them with an error tile instead of letting an ever-growing
        backlog starve fresh requests. Sheds from the front (oldest)."""
        if self.deadline_s is None or not self._pending:
            return
        now = time.perf_counter()
        remaining: deque[TileRequest] = deque()
        for req in self._pending:
            if now - req._t0 > self.deadline_s:
                self.shed += 1
                REGISTRY.counter("errors.shed_tiles").inc()
                self._complete(req, error_tile(self.pyramid.cfg.tile_size),
                               hit=False, failed=True)
                done.append(req)
            else:
                remaining.append(req)
        self._pending = remaining

    def tick(self) -> list[TileRequest]:
        """Render up to ``slots`` distinct pending tile addresses and
        complete every request waiting on them; returns completions.

        Degradation policy: a render that raises is isolated to its own
        spec — waiters get an ``error_tile`` with ``failed=True`` and the
        error tile is *never* cached, so a transient failure retries on
        the next request instead of poisoning the cache. With
        ``deadline_s`` set, overdue queued misses are shed the same way
        before any render work."""
        done: list[TileRequest] = []
        self._shed_overdue(done)
        if not self._pending:
            return done
        self.ticks += 1
        batch: list = []
        for req in self._pending:
            if req.spec not in batch:
                batch.append(req.spec)
                if len(batch) >= self.slots:
                    break
        t0 = time.perf_counter()
        tiles: dict = {}
        broken: set = set()
        with get_tracer().span("serve.tick", batch=len(batch)):
            for spec in batch:
                try:
                    tiles[spec] = self.pyramid.render_tile(spec)
                except Exception:
                    broken.add(spec)
                    self.failed += 1
                    REGISTRY.counter("errors.failed_tiles").inc()
        tick_s = time.perf_counter() - t0
        self.render_s += tick_s
        self.rendered += len(tiles)
        REGISTRY.histogram("serve.tick_render_s").record(tick_s)
        for spec, tile in tiles.items():
            self.cache.put(spec, tile)
        remaining = deque()
        for req in self._pending:
            if req.spec in tiles:
                self._complete(req, tiles[req.spec], hit=False)
                done.append(req)
            elif req.spec in broken:
                self._complete(req, error_tile(self.pyramid.cfg.tile_size),
                               hit=False, failed=True)
                done.append(req)
            else:
                remaining.append(req)
        self._pending = remaining
        self.publish_cache_metrics()
        return done

    def request(self, spec) -> np.ndarray:
        """Synchronous convenience: submit one address and tick to
        completion. Returns the tile image."""
        req = TileRequest(spec)
        self.submit(req)
        while not req.done:
            self.tick()
        return req.tile

    def warmup(self, levels=None, drills=()) -> int:
        """Precompute pyramid tiles (default: all ``depth`` levels) and the
        given drill-down communities straight into the cache (probes are
        stats-neutral). Returns tiles rendered."""
        n = 0
        specs = list(self.pyramid.specs(levels))
        specs += [DrillSpec(int(c)) for c in drills]
        with get_tracer().span("serve.warmup", tiles=len(specs)):
            for spec in specs:
                if spec not in self.cache:
                    t0 = time.perf_counter()
                    self.cache.put(spec, self.pyramid.render_tile(spec))
                    self.render_s += time.perf_counter() - t0
                    self.rendered += 1
                    n += 1
        self.publish_cache_metrics()
        return n


# ---------------------------------------------------------------------------
# Synthetic traffic


def synthetic_trace(
    pyramid: TilePyramid,
    n_requests: int,
    *,
    zipf_a: float = 1.1,
    pan_p: float = 0.45,
    zoom_p: float = 0.2,
    drill_frac: float = 0.05,
    drill_pool: int = 8,
    seed: int = 0,
) -> list:
    """Zipfian pan/zoom request trace over a pyramid — the traffic model
    behind ``launch/serve.py``.

    A session walks the pyramid: with probability ``pan_p`` the next
    request pans to a neighboring tile of the current level, with
    ``zoom_p`` it zooms one level in/out (coordinates re-anchored so the
    view stays over the same world region), with ``drill_frac`` it drills
    into one of the ``drill_pool`` largest drillable communities
    (zipf-weighted), and otherwise it jumps to a fresh tile drawn from a
    zipf(``zipf_a``) popularity ranking over all tiles (low-zoom tiles
    rank hottest, matching real tile-server skew). Deterministic in
    ``seed``; returns a list of ``TileSpec``/``DrillSpec``.
    """
    rng = np.random.default_rng(seed)
    specs = list(pyramid.specs())
    ranks = np.arange(1, len(specs) + 1, dtype=np.float64)
    popularity = ranks ** -float(zipf_a)
    popularity /= popularity.sum()
    drills = pyramid.drillable_communities()[:drill_pool]
    if len(drills):
        dranks = np.arange(1, len(drills) + 1, dtype=np.float64)
        dpop = dranks ** -float(zipf_a)
        dpop /= dpop.sum()
    trace: list = []
    cur = specs[0]
    for _ in range(n_requests):
        r = rng.random()
        if r < drill_frac and len(drills):
            trace.append(DrillSpec(int(rng.choice(drills, p=dpop))))
            continue  # drill is a detour; the pan/zoom session resumes
        if r < drill_frac + pan_p:
            n = pyramid.n_tiles(cur.level)
            dx, dy = rng.integers(-1, 2, size=2)
            cur = TileSpec(
                cur.level,
                int(np.clip(cur.x + dx, 0, n - 1)),
                int(np.clip(cur.y + dy, 0, n - 1)),
            )
        elif r < drill_frac + pan_p + zoom_p:
            if cur.level + 1 < pyramid.cfg.depth and rng.random() < 0.5:
                cur = TileSpec(
                    cur.level + 1,
                    int(2 * cur.x + rng.integers(0, 2)),
                    int(2 * cur.y + rng.integers(0, 2)),
                )
            elif cur.level > 0:
                cur = TileSpec(cur.level - 1, cur.x // 2, cur.y // 2)
        else:
            cur = specs[int(rng.choice(len(specs), p=popularity))]
        trace.append(cur)
    return trace
