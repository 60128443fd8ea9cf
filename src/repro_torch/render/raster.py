"""Streaming density-accumulation rasterizer: (positions, sizes, groups,
edges) → RGB image on the device (paper §4.3's colored drawing at
BigGraphVis scale).

* **edges** — splatted as ``RenderConfig.edge_samples`` points along each
  segment, each sample crediting the color group of its nearer endpoint.
  Chunks stream through the engine's ``EdgeChunkStream``, so host and
  device residency are independent of |E|.
* **nodes** — radius-∝-√size disks: disks up to ``SMALL_R`` pixels are
  rasterized over a ``BBOX``×``BBOX`` box around their centre by kernel
  K3's disk entry, which generates the box's pixels itself; the few larger
  disks take kernel K4, which walks each disk's own box.

Both passes accumulate **int32 counts** into a per-color buffer
[n_groups, H·ss, W·ss]. Integer adds are associative, so a chunked render
is bit-identical to a one-shot render. Tone mapping is log1p density →
palette-weighted color + saturating alpha, composited edges-under-nodes
over the background, then box-downsampled by the supersample factor.

Pixel coordinates are computed on the host in numpy, exactly as in the
reference package, so given the same positions both draw into the same
pixels.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.coloring import PALETTE
from repro_torch.core.stream import EdgeChunkStream, StreamStats, tree_bytes
from repro_torch.data.edge_store import as_edge_store
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.raster import ops as raster_ops
from repro_torch.kernels.raster.ref import SMALL_R, to_pixel
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer

_INT32_MAX = np.iinfo(np.int32).max
_MAX_INC = 1 << 20  # per-sample increment clamp (keeps counts far from 2³¹)


@dataclass(frozen=True)
class RenderConfig:
    """Rasterizer knobs. ``supersample`` renders at k× resolution and
    box-downsamples, ``edge_samples`` is points splatted per edge segment,
    and ``chunk_size``/``prefetch`` drive the edge pass. ``viewport``
    renders a fixed world rectangle ``(x0, y0, x1, y1)`` instead of
    auto-fitting the scene's bounding box. The kernels are chosen by the
    device, so there is no backend knob."""

    width: int = 1024
    height: int = 1024
    supersample: int = 1
    edge_samples: int = 8
    draw_edges: bool = True
    draw_nodes: bool = True
    chunk_size: int = 1 << 16  # edges resident on device per raster chunk
    prefetch: int = 1
    margin: float = 0.04  # blank border as a fraction of the image
    viewport: tuple | None = None  # world rect (x0, y0, x1, y1) to render
    background: tuple = (255, 255, 255)
    edge_gain: float = 1.0  # density → intensity gains (log1p tone map)
    node_gain: float = 4.0
    edge_alpha: float = 0.85  # max edge-layer opacity
    min_radius_px: float = 1.0  # node radius floor, in output pixels
    max_radius_frac: float = 0.125  # radius cap as a fraction of min(H, W)
    obs: object = None  # explicit Tracer for the render spans (None = global)


@dataclass
class RenderStats:
    """Per-render accounting. ``peak_device_bytes`` is the analytic
    resident footprint (accumulation buffers + node state + in-flight
    chunk buffers) — independent of |E|. ``stream`` carries the edge
    pass's engine-level accounting."""

    width: int = 0
    height: int = 0
    supersample: int = 1
    n_groups: int = 0
    nodes_drawn: int = 0
    edges_streamed: int = 0
    chunks: int = 0
    node_raster_s: float = 0.0
    edge_raster_s: float = 0.0
    compose_s: float = 0.0
    seconds: float = 0.0
    peak_device_bytes: int = 0
    stream: StreamStats | None = None
    timings: dict = field(default_factory=dict)

    @property
    def edges_per_s(self) -> float:
        return self.edges_streamed / self.edge_raster_s if self.edge_raster_s else 0.0

    @property
    def mpixels_per_s(self) -> float:
        px = self.width * self.height * self.supersample**2
        return px / self.seconds / 1e6 if self.seconds else 0.0

    def publish(self, registry=None) -> None:
        """Mirror this render's accounting into the metrics registry."""
        reg = registry if registry is not None else REGISTRY
        reg.counter("render.renders").inc()
        reg.counter("render.edges").inc(self.edges_streamed)
        for name, value in (
            ("render.node_raster_s", self.node_raster_s),
            ("render.edge_raster_s", self.edge_raster_s),
            ("render.compose_s", self.compose_s),
            ("render.seconds", self.seconds),
            ("render.edges_per_s", self.edges_per_s),
            ("render.mpixels_per_s", self.mpixels_per_s),
        ):
            reg.gauge(name).set(value)
        reg.gauge("render.peak_device_bytes").set_max(self.peak_device_bytes)


def _fit_transform(pos: np.ndarray, ws: int, hs: int, margin: float):
    """Uniform scale + center mapping world coords into the supersampled
    image with a blank margin, y flipped (world y-up → raster y-down)."""
    lo = pos.min(axis=0)
    hi = pos.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = (1.0 - 2.0 * margin) * min(ws / span[0], hs / span[1])
    center = (lo + hi) / 2.0
    return float(scale), float(center[0]), float(center[1])


def _viewport_transform(viewport, ws: int, hs: int):
    """Uniform scale + center mapping the fixed world rect onto the image."""
    x0, y0, x1, y1 = (float(c) for c in viewport)
    if not (x1 > x0 and y1 > y0):
        raise ValueError(f"degenerate viewport {viewport!r}: need x1>x0, y1>y0")
    scale = min(ws / (x1 - x0), hs / (y1 - y0))
    return scale, (x0 + x1) / 2.0, (y0 + y1) / 2.0


def _node_pass(px, py, r_px, groups, n_groups: int, hs: int, ws: int, device):
    """Hybrid node rasterization: K3's disk entry for disks up to SMALL_R
    pixels (work ∝ n·BBOX², not n·H·W), K4 for the (few) larger ones. The
    small-disk box covers every pixel such a disk can touch and the inside
    test is identical, so integer counts over the two node subsets sum to
    exactly the all-dense result. Host arrays in, [G, hs, ws] int32 device
    tensor out."""
    small = (r_px > 0) & (r_px <= SMALL_R)
    large = r_px > SMALL_R

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    acc = torch.zeros((n_groups, hs, ws), dtype=torch.int32, device=device)
    for pick, into in ((small, raster_ops.count_disks_into),
                       (large, raster_ops.disk_accum_into)):
        if pick.any():
            into(acc, dev(px[pick], torch.float32), dev(py[pick], torch.float32),
                 dev(r_px[pick], torch.float32), dev(groups[pick], torch.int32), n_groups)
    return acc


def _edge_splat_update(acc, chunk, pxy_ext, groups_ext, winc, hs: int, ws: int,
                       samples: int, n_groups: int):
    """One chunk of the streamed edge pass: sample segments, scatter-add
    into the flat int32 ``acc`` (in place, kernel K3)."""
    n_nodes = pxy_ext.shape[0] - 1
    u, v = chunk[:, 0].long(), chunk[:, 1].long()
    valid = (u >= 0) & (u < n_nodes) & (v >= 0) & (v < n_nodes)
    ui = u.clamp(0, n_nodes)
    vi = v.clamp(0, n_nodes)
    pu = pxy_ext[ui]  # [C, 2]
    pv = pxy_ext[vi]
    t = (torch.arange(samples, dtype=torch.float32, device=acc.device) + 0.5) / samples
    p = pu[:, None, :] + t[None, :, None] * (pv - pu)[:, None, :]  # [C, S, 2]
    ix = to_pixel(p[..., 0])
    iy = to_pixel(p[..., 1])
    # Each sample credits the color group of its nearer endpoint.
    g = torch.where(
        t[None, :] < 0.5, groups_ext[ui][:, None], groups_ext[vi][:, None]
    ).long()
    # Samples outside the image DROP (clamping would smear streaks).
    ok = (
        valid[:, None]
        & (g >= 0) & (g < n_groups)
        & (ix >= 0) & (ix < ws)
        & (iy >= 0) & (iy < hs)
    )
    flat = torch.where(ok, (g * hs + iy) * ws + ix, _INT32_MAX).to(torch.int32)
    inc = None if winc is None else winc[:, None].expand(flat.shape).reshape(-1)
    return raster_ops.count_scatter_into(acc, flat.reshape(-1), inc)


def _compose(node_acc, edge_acc, palette, background, node_gain, edge_gain,
             edge_alpha, ss: int):
    """Tone-map (log1p density), blend palette colors, composite
    edges-under-nodes over the background, box-downsample by ``ss``."""

    def layer(acc, gain):
        i = torch.log1p(gain * acc.to(torch.float32))  # [G, hs, ws]
        tot = torch.sum(i, dim=0)
        rgb = torch.einsum("ghw,gc->hwc", i, palette)
        rgb = rgb / torch.clamp(tot, min=1e-9)[..., None]
        alpha = 1.0 - torch.exp(-tot)
        return rgb, alpha

    some = node_acc if node_acc is not None else edge_acc
    img = background.expand(*some.shape[1:], 3)
    if edge_acc is not None:
        rgb, a = layer(edge_acc, edge_gain)
        a = (edge_alpha * a)[..., None]
        img = a * rgb + (1.0 - a) * img
    if node_acc is not None:
        rgb, a = layer(node_acc, node_gain)
        a = a[..., None]
        img = a * rgb + (1.0 - a) * img
    h, w = img.shape[0] // ss, img.shape[1] // ss
    img = img.reshape(h, ss, w, ss, 3).mean(dim=(1, 3))
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def render_arrays(pos, radii, groups, edge_source=None, *, edge_weights=None,
                  cfg: RenderConfig | None = None, device=None):
    """Rasterize a laid-out graph on ``device`` (None = CUDA) →
    ([H, W, 3] uint8 image, RenderStats).

    ``pos`` [n, 2] world coordinates, ``radii`` [n] world radii (≤ 0 slots
    are dead padding and draw nothing), ``groups`` [n] palette indices.
    ``edge_source`` is any engine edge source over node ids < n; ids ≥ n
    draw nothing. ``edge_weights`` (host [E] array) thickens edges by
    splat increment.
    """
    cfg = cfg or RenderConfig()
    device = resolve_device(device)
    pos = np.asarray(pos, np.float32).reshape(-1, 2)
    radii = np.asarray(radii, np.float32).reshape(-1)
    groups = np.asarray(groups, np.int32).reshape(-1)
    n = len(pos)
    if len(radii) != n or len(groups) != n:
        raise ValueError(
            f"pos/radii/groups disagree: {n}/{len(radii)}/{len(groups)} rows"
        )
    ss = max(1, int(cfg.supersample))
    hs, ws = cfg.height * ss, cfg.width * ss
    n_groups = len(PALETTE)
    if n_groups * hs * ws >= 2**31:
        raise ValueError(
            f"accumulation buffer {n_groups}×{hs}×{ws} overflows int32 "
            "flat indexing — lower resolution or supersample"
        )
    stats = RenderStats(
        width=cfg.width, height=cfg.height, supersample=ss, n_groups=n_groups
    )
    t_start = time.perf_counter()

    alive = radii > 0
    if cfg.viewport is not None:
        scale, ox, oy = _viewport_transform(cfg.viewport, ws, hs)
    else:
        bounds_src = pos[alive] if alive.any() else pos
        scale, ox, oy = _fit_transform(bounds_src, ws, hs, cfg.margin)
    px = (pos[:, 0] - ox) * scale + ws / 2.0
    py = hs / 2.0 - (pos[:, 1] - oy) * scale  # y-up world → y-down raster
    r_px = np.where(
        alive,
        np.clip(
            radii * scale, cfg.min_radius_px * ss,
            cfg.max_radius_frac * min(hs, ws),
        ),
        0.0,
    ).astype(np.float32)

    tr = cfg.obs if cfg.obs is not None else get_tracer()
    node_acc = None
    if cfg.draw_nodes and alive.any():
        t0 = time.perf_counter()
        with tr.span("render.nodes", n=n, hs=hs, ws=ws):
            node_acc = _node_pass(
                px.astype(np.float32), py.astype(np.float32), r_px, groups,
                n_groups, hs, ws, device,
            )
            synchronize(device)
        stats.node_raster_s = time.perf_counter() - t0
        stats.nodes_drawn = int(alive.sum())

    edge_acc = None
    sstats = None
    if cfg.draw_edges and edge_source is not None:
        store = as_edge_store(edge_source)
        stream = EdgeChunkStream(store, n, cfg.chunk_size)
        sstats = StreamStats(chunk_size=stream.chunk_size)
        pxy = np.concatenate([np.stack([px, py], 1), [[0.0, 0.0]]]).astype(np.float32)
        pxy_ext = torch.as_tensor(pxy, device=device)
        groups_ext = torch.as_tensor(
            np.concatenate([groups, [0]]).astype(np.int32), device=device
        )
        acc = torch.zeros(n_groups * hs * ws, dtype=torch.int32, device=device)
        cs = stream.chunk_size
        weights = None if edge_weights is None else np.asarray(edge_weights)
        t0 = time.perf_counter()
        with tr.span("render.edges", chunk_size=cs, samples=cfg.edge_samples):
            for i, chunk in enumerate(
                stream.device_chunks(device, cfg.prefetch, sstats)
            ):
                winc = None
                if weights is not None:
                    wsl = weights[i * cs:(i + 1) * cs]
                    if len(wsl) < cs:
                        wsl = np.pad(wsl, (0, cs - len(wsl)))
                    winc = torch.as_tensor(
                        np.clip(np.round(wsl), 1, _MAX_INC).astype(np.int32),
                        device=device,
                    )
                with tr.span("render.edge_chunk", chunk=i):
                    _edge_splat_update(
                        acc, chunk, pxy_ext, groups_ext, winc,
                        hs, ws, cfg.edge_samples, n_groups,
                    )
                sstats.chunks += 1
                sstats.edges_streamed += chunk.shape[0]
            synchronize(device)
        stats.edge_raster_s = time.perf_counter() - t0
        sstats.passes += 1
        sstats.seconds = stats.edge_raster_s
        edge_acc = acc.reshape(n_groups, hs, ws)
        stats.edges_streamed = sstats.edges_streamed
        stats.chunks = sstats.chunks
        stats.peak_device_bytes += (
            stream.chunk_bytes * stream.inflight_buffers(cfg.prefetch)
            + tree_bytes(pxy_ext, groups_ext)
        )
        sstats.peak_device_bytes = stats.peak_device_bytes + tree_bytes(
            edge_acc, node_acc
        )
        sstats.peak_host_bytes = stream.host_bytes(cfg.prefetch)

    t0 = time.perf_counter()
    with tr.span("render.compose", ss=ss):
        if node_acc is None and edge_acc is None:
            image = np.broadcast_to(
                np.asarray(cfg.background, np.uint8), (cfg.height, cfg.width, 3)
            ).copy()
        else:
            image = _compose(
                node_acc,
                edge_acc,
                torch.as_tensor(PALETTE, dtype=torch.float32, device=device),
                torch.as_tensor(np.asarray(cfg.background, np.float32), device=device),
                cfg.node_gain,
                cfg.edge_gain,
                cfg.edge_alpha,
                ss,
            ).cpu().numpy()
    stats.compose_s = time.perf_counter() - t0
    stats.peak_device_bytes += tree_bytes(node_acc, edge_acc)
    stats.seconds = time.perf_counter() - t_start
    stats.stream = sstats
    stats.timings = {
        "node_raster_s": stats.node_raster_s,
        "edge_raster_s": stats.edge_raster_s,
        "compose_s": stats.compose_s,
    }
    stats.publish()
    return image, stats


def render(result, path: str | None = None, cfg: RenderConfig | None = None,
           device=None):
    """Render a ``BGVResult`` supergraph drawing (paper §4.3): supernode
    disks radius ∝ √size, superedges weighted by aggregated multiplicity.
    Writes a PNG when ``path`` is given; returns (image, RenderStats)."""
    cfg = cfg or RenderConfig()
    sizes = np.maximum(np.asarray(result.sizes, np.float32), 0.0)
    radii = np.sqrt(sizes)  # paper §4.1: radius ∝ √size; 0 = dead slot
    sg = result.supergraph
    edge_source = None
    weights = None
    if cfg.draw_edges and sg is not None:
        edge_source = sg.edges.cpu().numpy()
        weights = sg.weights.cpu().numpy()
    image, stats = render_arrays(
        result.positions, radii, result.groups,
        edge_source, edge_weights=weights, cfg=cfg, device=device,
    )
    if path is not None:
        from repro_torch.render.png import write_png

        write_png(path, image)
    return image, stats


def image_summary(image: np.ndarray, background: tuple = (255, 255, 255),
                  tol: float = 60.0) -> tuple[float, np.ndarray]:
    """(non-background pixel fraction, per-palette-entry pixel counts).

    A pixel counts toward a palette entry when that entry is its nearest
    palette color within euclidean RGB distance ``tol`` — the smoke
    content check (≥ 1% non-background, ≥ 3 palette colors).
    """
    flat = np.asarray(image).reshape(-1, 3).astype(np.int32)
    bg = np.asarray(background, np.int32)
    nonbg = np.any(flat != bg, axis=1)
    frac = float(nonbg.mean()) if len(flat) else 0.0
    sub = flat[nonbg]
    counts = np.zeros(len(PALETTE), np.int64)
    if len(sub):
        d2 = ((sub[:, None, :] - PALETTE.astype(np.int32)[None]) ** 2).sum(-1)
        near = d2.argmin(axis=1)
        close = d2[np.arange(len(sub)), near] <= tol * tol
        counts = np.bincount(near[close], minlength=len(PALETTE)).astype(np.int64)
    return frac, counts
