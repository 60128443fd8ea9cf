"""End-to-end BigGraphVis pipeline (paper Fig. 2 / Algorithm 3):

    edge stream ──► SCoDA communities ──► CMS sizing ──► supergraph
                ──► ForceAtlas2 layout ──► colored supernode drawing
                ──► rasterized image (``BGVResult.render``)

plus the paper's second output mode, ``full_layout_colored``: a full-graph
ForceAtlas2 layout (grid repulsion above 4,096 nodes) colored by the
detected communities (§4.3).

Every edge-consuming stage runs through the streaming chunked-edge engine
(core/stream.py): ``biggraphvis()`` processes the edge list as one chunk by
default and as fixed-size chunks (device residency independent of |E|)
when given a ``StreamConfig``. Both produce identical results, and a run
checkpointed at chunk boundaries resumes bit-identically after a kill
(``checkpoint=``/``resume=``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import cms as cms_lib
from repro_torch.core import forceatlas2 as fa2
from repro_torch.core.coloring import color_groups
from repro_torch.core.scoda import ScodaConfig, detect_communities
from repro_torch.core.stream import StreamConfig, StreamStats, stream_pipeline
from repro_torch.core.supergraph import Supergraph, build_supergraph
from repro_torch.device import host_array, resolve_device, synchronize
from repro_torch.graph.utils import degrees, pad_edges
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer


@dataclass(frozen=True)
class BGVConfig:
    scoda: ScodaConfig
    cms: cms_lib.CMSConfig
    layout: fa2.FA2Config
    s_cap: int = 65536  # supernode capacity
    max_super_edges: int = 262144
    obs: object = None  # explicit Tracer for the whole run (None = global)


@dataclass
class BGVResult:
    # [s_cap, 2] in the layout's type; a bfloat16 layout as float32 holding
    # its values (numpy has no bfloat16)
    positions: np.ndarray
    sizes: np.ndarray  # [s_cap]
    groups: np.ndarray  # [s_cap] color group
    labels: np.ndarray  # [n] node → dense community
    supergraph: Supergraph
    modularity: float
    n_supernodes: int
    n_superedges: int
    timings: dict = field(default_factory=dict)
    stream: StreamStats | None = None  # chunked-engine accounting
    obs: object = field(default=None, repr=False)  # Tracer from the run
    device: torch.device | None = None  # where the run's tensors live

    def render(self, path: str | None = None, cfg=None):
        """Rasterize this result's supergraph drawing (paper §4.3) on the
        device the result was computed on. ``path`` additionally writes a
        PNG; ``cfg`` is an optional ``RenderConfig``. Returns ``(image
        [H, W, 3] uint8, RenderStats)`` and records the wall time in
        ``timings["render_s"]``."""
        import dataclasses

        from repro_torch.render.raster import RenderConfig
        from repro_torch.render.raster import render as render_result

        tr = self.obs if self.obs is not None else get_tracer()
        if self.obs is not None:
            if cfg is None:
                cfg = RenderConfig(obs=tr)
            elif getattr(cfg, "obs", None) is None:
                cfg = dataclasses.replace(cfg, obs=tr)
        t0 = time.perf_counter()
        with tr.span("render", path=path or ""):
            out = render_result(self, path, cfg=cfg, device=self.device)
        self.timings["render_s"] = time.perf_counter() - t0
        return out


def default_cms_cols(n_edges: int) -> int:
    """Count-min-sketch width used by ``default_config``:
    ``max(256, |E| // 1000)`` — one column per ~1000 edges keeps the §4.2
    size estimates reliable for 4 hash rows."""
    return max(256, n_edges // 1000)


def default_config(
    n_nodes: int,
    n_edges: int,
    degree_threshold: int,
    rounds: int = 4,
    iterations: int = 100,
    s_cap: int | None = None,
    repulsion: str = "exact",
    grid_size: int = 64,
    grid_window: int = 32,
    grid_rebuild: int = 1,
    stop_tolerance: float = 0.0,
    min_iterations: int = 0,
    init: str = "random",
    nan_guard: bool = False,
) -> BGVConfig:
    """Paper-shaped defaults: 4 hash rows, CMS cols = ``default_cms_cols``,
    δ = mode degree.

    ``repulsion``/``grid_*`` select the FA2 backend of the supergraph layout
    and seed the grid knobs ``full_layout_colored`` reuses ("exact" for
    supergraphs, "grid" for full graphs). ``stop_tolerance``/
    ``min_iterations`` enable the adaptive stop, ``init`` picks the starting
    positions ("random" | "degree" | "bfs") and ``nan_guard`` the divergence
    sentinel; ``full_layout_colored`` inherits them too.
    """
    cols = default_cms_cols(n_edges)
    return BGVConfig(
        scoda=ScodaConfig(degree_threshold=degree_threshold, rounds=rounds),
        cms=cms_lib.CMSConfig(rows=4, cols=cols),
        layout=fa2.FA2Config(
            iterations=iterations, repulsion=repulsion, grid_size=grid_size,
            grid_window=grid_window, grid_rebuild=grid_rebuild,
            stop_tolerance=stop_tolerance, min_iterations=min_iterations,
            init=init, nan_guard=nan_guard,
        ),
        s_cap=s_cap or min(n_nodes, 65536),
        max_super_edges=min(4 * n_edges, 262144),
    )


def layout_supergraph(sg: Supergraph, cfg: BGVConfig, tracer=None,
                      device=None, mesh=None,
                      shard_layout: bool = False) -> tuple[torch.Tensor, int]:
    """ForceAtlas2 on the (small, device-resident) supergraph.

    Returns ``(positions [s_cap, 2], iterations_run)``. The layout is sized
    to the LIVE supernode count padded to a power of two (≥ 64, ≤ s_cap):
    laying out the full s_cap padding would erase the paper's headline
    speedup.

    With ``mesh`` + ``shard_layout`` the force pass is node-partitioned over
    the mesh's ranks (``fa2.layout_sharded``, with its own fallbacks); the
    span's ``sharded`` attribute says whether it engaged. ``s_layout`` is a
    power of two ≥ 64, so it divides by any power-of-two rank count.
    """
    tr = tracer if tracer is not None else get_tracer()
    device = resolve_device(device if device is not None else sg.sizes.device)
    s_live = max(int(sg.n_supernodes), 2)
    s_layout = 1 << (s_live - 1).bit_length()
    s_layout = min(max(s_layout, 64), cfg.s_cap)
    e_live = max(int(sg.n_superedges), 1)
    e_layout = min(1 << (e_live - 1).bit_length(), sg.edges.shape[0])
    live = torch.arange(s_layout, device=device) < sg.n_supernodes
    mass = torch.clamp(sg.sizes[:s_layout], min=0.0) + live.to(torch.float32)
    mass = torch.where(live, mass, 0.0)
    sedges = torch.clamp(sg.edges[:e_layout], max=s_layout)  # trash → s_layout
    sharded = bool(mesh is not None and shard_layout)
    engaged = sharded and fa2._sharded_fallback_reason(s_layout, cfg.layout, mesh) is None
    with tr.span("layout.supergraph", n=s_layout, edges=e_layout, sharded=engaged):
        if sharded:
            pos_live, trace, iters_run = fa2.layout_sharded(
                sedges, sg.weights[:e_layout], mass, s_layout, cfg.layout, mesh,
                device=device)
        else:
            pos_live, trace, iters_run = fa2.layout(
                sedges, sg.weights[:e_layout], mass, s_layout, cfg.layout,
                device=device)
        synchronize(device)
    if cfg.layout.nan_guard:
        recovered = fa2.recovery_count(trace)
        if recovered:
            REGISTRY.counter("errors.fa2_recoveries").inc(recovered)
    pos = torch.zeros((cfg.s_cap, 2), dtype=pos_live.dtype, device=device)
    pos[:s_layout] = pos_live
    return pos, int(iters_run)


def biggraphvis(source, n_nodes: int, cfg: BGVConfig,
                stream: StreamConfig | None = None, *, checkpoint=None,
                resume=False, device=None, put=None) -> BGVResult:
    """Run the whole pipeline on ``device`` (None = CUDA, or the mesh's
    device when ``stream.mesh`` is set; raises without CUDA).

    ``source`` is any engine edge source: an [E,2] unpadded int32 host
    array, an ``EdgeStore``, or a path to a ``.npy`` / ``.bin`` edge file or
    shard directory. ``stream=None`` feeds the whole edge list as a single
    chunk; a ``StreamConfig`` streams it in fixed-size chunks. Both produce
    identical results.

    ``checkpoint`` (a ``resilience.StreamCheckpointer``) and ``resume``
    forward to the streaming engine (``core/stream.stream_pipeline``): the
    edge-consuming stages persist their state at chunk boundaries and a
    killed run restarts bit-identically from the newest checkpoint. The
    layout and coloring run again after a resume.

    Multi-device: with ``stream.mesh`` (a ``launch.mesh.StreamMesh``) every
    rank calls this with the same arguments; ``stream.shard_detect``
    spreads the edge passes and ``stream.shard_layout`` the supergraph
    layout over the ranks, and every rank returns the single-rank result.
    ``put``
    forwards to ``stream_pipeline``.
    """
    mesh = stream.mesh if stream is not None else None
    device = resolve_device(device if device is not None or mesh is None
                            else mesh.device)
    tr = cfg.obs
    if tr is None and stream is not None:
        tr = stream.obs
    if tr is None:
        tr = get_tracer()
    with tr.span("biggraphvis", n_nodes=n_nodes, s_cap=cfg.s_cap):
        labels, _gdeg, sg, q, stats = stream_pipeline(
            source, n_nodes, cfg.scoda, cfg.cms, cfg.s_cap, cfg.max_super_edges,
            stream, tracer=tr, checkpoint=checkpoint, resume=resume,
            device=device, put=put,
        )
        t = {
            "scoda_s": stats.stage_seconds["detect_s"],
            "supergraph_s": stats.stage_seconds["supergraph_s"],
        }
        t0 = time.perf_counter()
        with tr.span("layout", iterations=cfg.layout.iterations,
                     repulsion=cfg.layout.repulsion):
            pos, layout_iters = layout_supergraph(
                sg, cfg, tracer=tr, device=device, mesh=mesh,
                shard_layout=bool(stream is not None and stream.shard_layout))
        t["layout_s"] = time.perf_counter() - t0
        t["layout_iterations"] = layout_iters
        REGISTRY.counter("layout.runs").inc()
        REGISTRY.gauge("layout.iterations_run").set(layout_iters)
        REGISTRY.gauge("layout.seconds").set(t["layout_s"])
        REGISTRY.gauge("layout.converged").set(
            int(layout_iters < cfg.layout.iterations)
        )
        groups = color_groups(sg.sizes)
    return BGVResult(
        positions=host_array(pos),
        sizes=sg.sizes.cpu().numpy(),
        groups=groups.cpu().numpy(),
        labels=sg.labels.cpu().numpy(),
        supergraph=sg,
        modularity=float(q),
        n_supernodes=int(sg.n_supernodes),
        n_superedges=int(sg.n_superedges),
        timings=t,
        stream=stats,
        obs=cfg.obs if cfg.obs is not None
        else (stream.obs if stream is not None else None),
        device=device,
    )


def full_layout_colored(edges_np: np.ndarray, n_nodes: int, cfg: BGVConfig,
                        iterations: int = 500, stop_tolerance: float | None = None,
                        min_iterations: int | None = None,
                        device=None) -> tuple[np.ndarray, np.ndarray]:
    """The paper's comparison path on ``device`` (None = CUDA): a full-graph
    FA2 layout colored by the BigGraphVis communities. Returns host arrays
    ``(pos [n, 2], groups [n])``.

    ``cfg.layout.repulsion == "exact"`` (the supergraph default) counts as
    unset here and becomes "grid" above 4,096 nodes (an exact full-graph
    layout at larger n is a deliberate O(n²) choice: call ``fa2.layout``
    for that). ``stop_tolerance``/``min_iterations`` override the config's
    adaptive-stop knobs for this call; None inherits them.

    Stages run in the spans ``layout.full.detect``, ``layout.full.supergraph``
    and ``layout.full``, each ending in a device synchronize so its duration
    is the device's; the gauge ``layout.full_iterations_run`` holds the live
    iteration count. ``pos`` is of the layout's type (``cfg.layout.dtype``),
    a bfloat16 layout as float32 holding its values.
    """
    device = resolve_device(device)
    tr = cfg.obs if cfg.obs is not None else get_tracer()
    e_cap = len(edges_np)
    edges = torch.as_tensor(pad_edges(edges_np, e_cap, n_nodes), device=device)
    with tr.span("layout.full.detect", n=n_nodes, edges=e_cap):
        deg = degrees(edges, n_nodes)
        labels, _ = detect_communities(edges, n_nodes, cfg.scoda)
        synchronize(device)
    with tr.span("layout.full.supergraph", s_cap=cfg.s_cap):
        sg = build_supergraph(edges, labels, deg, n_nodes, cfg.s_cap,
                              cfg.max_super_edges, cfg.cms)
        synchronize(device)
    repulsion = (
        cfg.layout.repulsion
        if cfg.layout.repulsion != "exact"
        else ("grid" if n_nodes > 4096 else "exact")
    )
    lcfg = fa2.FA2Config(
        iterations=iterations,
        repulsion=repulsion,
        grid_size=cfg.layout.grid_size,
        grid_window=cfg.layout.grid_window,
        grid_rebuild=cfg.layout.grid_rebuild,
        use_radii=False,
        gravity=cfg.layout.gravity,
        repulsion_k=cfg.layout.repulsion_k,
        dtype=cfg.layout.dtype,
        stop_tolerance=(
            cfg.layout.stop_tolerance if stop_tolerance is None else stop_tolerance
        ),
        min_iterations=(
            cfg.layout.min_iterations if min_iterations is None else min_iterations
        ),
        init=cfg.layout.init,
        init_bfs_rounds=cfg.layout.init_bfs_rounds,
        nan_guard=cfg.layout.nan_guard,
    )
    mass = deg.to(torch.float32) + 1.0
    w = torch.ones(edges.shape[0], dtype=torch.float32, device=device)
    with tr.span("layout.full", n=n_nodes, repulsion=repulsion):
        pos, trace, iters_run = fa2.layout(edges, w, mass, n_nodes, lcfg, device=device)
        synchronize(device)
    if lcfg.nan_guard:
        recovered = fa2.recovery_count(trace)
        if recovered:
            REGISTRY.counter("errors.fa2_recoveries").inc(recovered)
    REGISTRY.gauge("layout.full_iterations_run").set(int(iters_run))
    node_groups = color_groups(sg.sizes)[torch.clamp(sg.labels, 0, cfg.s_cap - 1).long()]
    return host_array(pos), node_groups.cpu().numpy()
