"""ForceAtlas2 (Jacomy et al. 2014) — paper §3.1 / Algorithm 1.

Force model:
  * gravity            f_g(i)  = kg · m_i · (towards origin)
  * attraction         f_a(e)  = w_e · (x_v − x_u)            (linear FA2)
  * repulsion          f_r(i,j)= kr · m_i · m_j / d(i,j)       (along unit vec)
  * adaptive speed     swing/traction + global & local speeds  (Algorithm 1 l.23)

with mass m_i = deg_i + 1 for plain graphs and m_i = community size for
supernodes (paper §4.1: radius ∝ √size; repulsion distance shifted by radii
so big supernodes get the space they need).

Repulsion backends (``repulsion=``); the device of the tensors picks the
kernels, so there is no backend per kernel:

  * "exact"       — the O(n²) pairwise sum: kernel K2 on the card
                    (``kernels/repulsion``), its plain version on the CPU.
                    The only backend that honours ``use_radii``; right for
                    supergraphs.
  * "grid"        — uniform-grid monopole far field + banded same-cell near
                    field (``kernels/grid``): kernels K5, K6 and K7 on the
                    card. O(n·(G² + W)) work — the full-graph path.
  * "grid_pallas" — the same as "grid". The reference uses the name to
                    force its TPU kernels; here the device already decides.
  * "grid_dense"  — the dense baseline, plain torch only, materialising an
                    [n, G², 2] far-field tensor per iteration (≈ 22 GB at
                    685,230 nodes with G = 64). Kept as a semantics oracle
                    for tests; never run it at full width.

``layout`` hoists everything reusable out of the iteration loop: radii
√mass are computed once, and attraction edges are sorted once into a
directed source-sorted layout with its sources' segment layout, whose
per-iteration sum is one launch of K7's fused ``attraction_sum`` on the
card (the terms formed as they are added) and its plain version, one
``index_add_``, on the CPU, in the same order (so a layout on the card is
the same bits from run to run). The grid backends carry (cell ids,
cell-sorted order) through the loop and rebuild them every
``grid_rebuild`` iterations (iteration 0 always rebuilds; 1 = every
iteration). The loop is Python; with
``stop_tolerance`` > 0 it stops once the controller's global swing falls to
``stop_tolerance`` × global traction (after ``min_iterations``), leaving the
remaining trace rows zero — frozen iterations do no work. That test reads
one flag from the device per iteration, so it is only paid when the stop is
enabled.

``nan_guard`` rolls back an iteration whose forces hold a non-finite value
(positions and controller memory kept, global speed halved) and traces it
as a ``[-1, -1, damped]`` row, without reading anything back to the host.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.grid import ops as grid_ops
from repro_torch.kernels.repulsion import ops as repulsion_ops
from repro_torch.kernels.segment import ops as segment_ops
from repro_torch.obs.trace import get_tracer

_GOLDEN_ANGLE = 2.3999632297286533  # π(3 − √5)
_BACKENDS = ("exact", "grid", "grid_pallas", "grid_dense")


@dataclass(frozen=True)
class FA2Config:
    iterations: int = 100
    gravity: float = 1.0
    repulsion_k: float = 80.0  # paper §5.1: kr = 80, kg = 1 for all networks
    strong_gravity: bool = False
    jitter_tolerance: float = 1.0  # τ in the FA2 speed controller
    repulsion: str = "exact"  # "exact" | "grid" | "grid_pallas" | "grid_dense"
    grid_size: int = 64
    grid_window: int = 32  # near-field band half-width of grid repulsion
    grid_rebuild: int = 1  # re-bin/re-sort cells every k iterations
    use_radii: bool = True  # supernode radii shift repulsion distances
    seed: int = 0
    dtype: str = "float32"  # position/force dtype of the layout loop
    stop_tolerance: float = 0.0  # adaptive stop (0.0 = fixed iterations)
    min_iterations: int = 0  # never stop before this many iterations
    init: str = "random"  # "random" | "degree" | "bfs"
    init_bfs_rounds: int = 32  # BFS depth-propagation rounds for init="bfs"
    nan_guard: bool = False  # divergence sentinel (see module docstring)


def _check_backend(cfg: FA2Config) -> None:
    if cfg.repulsion not in _BACKENDS:
        raise ValueError(
            f"unknown repulsion backend {cfg.repulsion!r}: expected one of {_BACKENDS}"
        )


def init_positions(n: int, seed: int, scale: float = 1000.0, dtype=torch.float32,
                   device="cpu"):
    """Uniform positions in [-scale, scale)² drawn on ``device``: the
    reference's uniform draw of shape (n, 2) for ``seed``, bit for bit
    (``prng``)."""
    return prng.uniform(prng.key(seed), (n, 2), -scale, scale, dtype, device)


def init_positions_degree(n: int, mass, scale: float = 1000.0,
                          dtype=torch.float32):
    """Degree-greedy sunflower init: nodes placed on a golden-angle spiral
    in descending-mass order, so hubs start at the center and leaves at the
    rim. Deterministic (the stable sort breaks ties by index)."""
    order = torch.argsort(-mass, stable=True)
    rank = torch.empty(n, dtype=torch.int32, device=mass.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=mass.device)
    rf = rank.to(torch.float32)
    # r and θ are the reference's float32 values: the square root is taken
    # in float64 and rounded once, which is the correctly rounded float32
    # root (torch's vectorised float32 root on the CPU is not, for some
    # elements). The products are formed in float64 and rounded to float32
    # once: a float32 sine or cosine rounds differently in the vectorised
    # loop and in its scalar tail, so the result would depend on where an
    # element falls, that is, on the CPU's vector width.
    root = torch.sqrt(((rf + 0.5) / n).to(torch.float64)).to(torch.float32)
    r = scale * root
    theta = rf * _GOLDEN_ANGLE
    r64, t64 = r.to(torch.float64), theta.to(torch.float64)
    pos = torch.stack([r64 * torch.cos(t64), r64 * torch.sin(t64)], dim=1)
    return pos.to(torch.float32).to(dtype)


def init_positions_bfs(edges, mass, n: int, seed: int,
                       rounds: int = 32, smooth_rounds: int = 10,
                       scale: float = 1000.0, dtype=torch.float32):
    """BFS-ring + neighbor-smoothing init: hop depths from the heaviest node
    via ``rounds`` scatter-min relaxations, radius ∝ depth, golden-angle
    azimuth with a small radial jitter (the reference's draw for ``seed``,
    bit for bit); then ``smooth_rounds`` sweeps pull each node halfway to
    its neighbors' centroid (rescaled to the scaffold's RMS radius). Padded
    edge slots (endpoint == n) write to a trash row that is reset or
    dropped. Within a few ulp of max|pos| of the reference's, which takes
    its float32 trigonometry and its sums in other roundings and orders."""
    dev = mass.device
    e = edges.long().clamp(0, n)
    u, v = e[:, 0], e[:, 1]
    seed_node = int(torch.argmax(mass))
    unreached = rounds + 1
    depth = torch.full((n + 1,), unreached, dtype=torch.int32, device=dev)
    depth[seed_node] = 0
    for _ in range(rounds):
        new = depth.scatter_reduce(0, v, depth[u] + 1, "amin", include_self=True)
        new = new.scatter_reduce(0, u, depth[v] + 1, "amin", include_self=True)
        new[n] = unreached
        depth = new
    depth = depth[:n]
    deepest = torch.where(depth >= unreached, 0, depth).max()
    d = torch.where(depth >= unreached, deepest + 1, depth).to(torch.float32)
    r = scale * (d + 0.5) / (deepest.to(torch.float32) + 1.5)
    jitter = prng.uniform(prng.key(seed), (n,), dtype=torch.float32, device=dev)
    r = r * (0.9 + 0.2 * jitter)
    theta = torch.arange(n, dtype=torch.float32, device=dev) * _GOLDEN_ANGLE
    # The float32 cosine and sine correctly rounded (taken in float64):
    # torch's float32 ones on the CPU depend on the vector width, and the
    # reference's are within an ulp of these.
    t64 = theta.to(torch.float64)
    pos = torch.stack([r * torch.cos(t64).to(torch.float32),
                       r * torch.sin(t64).to(torch.float32)], dim=1)

    one = torch.ones(u.shape[0], dtype=torch.float32, device=dev)
    deg = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    deg.index_add_(0, u, one).index_add_(0, v, one)
    degn = torch.clamp(deg[:n], min=1.0)
    has_nbr = (deg[:n] > 0.0)[:, None]
    rms0 = torch.sqrt(torch.mean(torch.sum(pos * pos, dim=1)))
    for _ in range(smooth_rounds):
        ext = torch.cat([pos, torch.zeros((1, 2), dtype=pos.dtype, device=dev)])
        s = torch.zeros((n + 1, 2), dtype=pos.dtype, device=dev)
        s.index_add_(0, u, ext[v]).index_add_(0, v, ext[u])
        mean = s[:n] / degn[:, None]
        new = torch.where(has_nbr, 0.5 * pos + 0.5 * mean, pos)
        rms = torch.sqrt(torch.mean(torch.sum(new * new, dim=1)))
        pos = new * (rms0 / torch.clamp(rms, min=1e-9))
    return pos.to(dtype)


def initial_positions(edges, mass, n: int, cfg: FA2Config):
    """Dispatch ``cfg.init`` on ``mass``'s device; "random" and "bfs" draw
    the reference's bits for ``cfg.seed``."""
    dtype = getattr(torch, cfg.dtype)
    if cfg.init == "random":
        return init_positions(n, cfg.seed, dtype=dtype, device=mass.device)
    if cfg.init == "degree":
        return init_positions_degree(n, mass, dtype=dtype)
    if cfg.init == "bfs":
        return init_positions_bfs(edges, mass, n, cfg.seed, rounds=cfg.init_bfs_rounds,
                                  dtype=dtype)
    raise ValueError(
        f"unknown init {cfg.init!r}: expected 'random', 'degree', or 'bfs'"
    )


def _gravity(pos, mass, cfg: FA2Config):
    if cfg.strong_gravity:
        return -cfg.gravity * mass[:, None] * pos
    d = torch.linalg.vector_norm(pos, dim=-1, keepdim=True)
    unit = pos / torch.clamp(d, min=1e-9)
    return -cfg.gravity * mass[:, None] * unit


def _attraction(pos, edges, weights, n: int):
    """Σ over incident edges of w·(x_other − x_self); padded slots hit trash.
    Unsorted two-scatter form — the single-``step`` path.

    On the CPU two ``index_add_`` calls add, into each node, its u-terms in
    edge order and then its v-terms. On the card ``[f; −f]`` is summed by
    K7 through the segment layout of ``[u; v]`` built for this call (a
    stable sort by id), which adds the same terms in the same order: the
    same bits, every run. A fake ``pos`` (a dry run) takes the card's form."""
    e = edges.long().clamp(0, n)
    u, v = e[:, 0], e[:, 1]
    pos_ext = torch.cat([pos, torch.zeros((1, 2), dtype=pos.dtype, device=pos.device)])
    f = weights[:, None] * (pos_ext[v] - pos_ext[u])  # force on u toward v
    if build.on_card(pos):
        if f.dtype != torch.float32:
            raise ValueError(f"the attraction sums in float32 on the card (K7), got {f.dtype}")
        return segment_ops.segment_sum_edges(torch.cat([f, -f]),
                                             torch.cat([u, v]).to(torch.int32), n)
    force = torch.zeros((n + 1, 2), dtype=pos.dtype, device=pos.device)
    force.index_add_(0, u, f)
    force.index_add_(0, v, -f)
    return force[:n]


def _attraction_edge_layout(edges, weights, n: int):
    """Directed source-sorted layout, built once per ``layout`` call:
    ``(dst, w, layout)``, both edge directions stably sorted by source node
    (ids as int32), and the ``SegmentLayout`` of the sources clamped into
    ``[0, n]`` (its offsets by K7's ``segment_offsets`` on the card).
    Padded slots (trash endpoints == n) sort last and fall past
    ``offsets[n]``."""
    u, v = edges[:, 0].to(torch.int32), edges[:, 1].to(torch.int32)
    src = torch.cat([u, v])
    dst = torch.cat([v, u])
    w2 = torch.cat([weights, weights])
    order = torch.argsort(src, stable=True)
    layout = segment_ops.segment_layout(src[order].clamp(0, n), n, sorted=True)
    return dst[order], w2[order], layout


def _attraction_sorted(pos, dst, w, layout):
    """Σ over directed incident edges of w·(x_dst − x_src), node by node
    through the sources' ``layout`` (dst ≥ n reads a zero row): K7's
    ``attraction_sum`` on the card, its plain version (one ``index_add_``)
    on the CPU."""
    return segment_ops.attraction_sum(pos, dst, w, layout)


def _pair_force(dpos, mi, mj, kr):
    """kr·mi·mj/d along the unit vector, for a [..., 2] displacement."""
    d2 = torch.sum(dpos * dpos, dim=-1)
    mag = kr * mi * mj / torch.clamp(d2, min=1e-4)  # (1/d along unit) = 1/d²·vec
    return mag[..., None] * dpos


def _grid_repulsion(pos, mass, cfg: FA2Config):
    """Dense uniform-grid repulsion — the ``grid_dense`` baseline.

    The monopole far field and banded near field of ``kernels/grid`` in the
    fully materialised form: an [n, G², 2] far-field tensor (the own-cell
    monopole added and subtracted again) and an [n, 2W+1] near-field gather
    per call. Plain torch on any device; a semantics oracle for tests.
    """
    g = cfg.grid_size
    window = cfg.grid_window
    n = pos.shape[0]
    kr = cfg.repulsion_k
    dev = pos.device
    lo = pos.min(dim=0).values
    hi = pos.max(dim=0).values
    extent = torch.clamp(hi - lo, min=1e-6)
    cell2d = torch.clamp(((pos - lo) / extent * g).to(torch.int32), 0, g - 1)
    cell = (cell2d[:, 0] * g + cell2d[:, 1]).long()
    n_cells = g * g
    cmass = torch.zeros(n_cells, dtype=pos.dtype, device=dev).index_add_(0, cell, mass)
    cpos = torch.zeros((n_cells, 2), dtype=pos.dtype, device=dev).index_add_(
        0, cell, pos * mass[:, None])
    ccent = cpos / torch.clamp(cmass, min=1e-9)[:, None]

    # Far field: node → every cell monopole, then the own cell subtracted.
    diff = pos[:, None, :] - ccent[None, :, :]  # [n, G², 2]
    force = torch.sum(_pair_force(diff, mass[:, None], cmass[None, :], kr), dim=1)
    force = force - _pair_force(pos - ccent[cell], mass, cmass[cell], kr)

    # Exact near field: same-cell neighbours are contiguous after sorting.
    order = torch.argsort(cell, stable=True)
    inv = torch.empty(n, dtype=torch.long, device=dev)
    inv[order] = torch.arange(n, device=dev)
    pos_s, mass_s, cell_s = pos[order], mass[order], cell[order]
    p = torch.arange(n, device=dev)
    raw = p[:, None] + torch.arange(-window, window + 1, device=dev)[None, :]
    in_range = (raw >= 0) & (raw < n)  # clipping would duplicate endpoints
    nbr = torch.clamp(raw, 0, n - 1)
    same = in_range & (cell_s[nbr] == cell_s[:, None]) & (nbr != p[:, None])
    dn = pos_s[:, None, :] - pos_s[nbr]
    fn = _pair_force(dn, mass_s[:, None], torch.where(same, mass_s[nbr], 0.0), kr)
    return force + torch.sum(fn, dim=1)[inv]


def _repulsion_forces(pos, mass, radii, cfg: FA2Config, cell=None, order=None,
                      rows=None, gather=None):
    """One iteration's repulsion on the configured backend. With ``rows=(i0,
    nl)`` only the forces on nodes ``[i0, i0 + nl)`` ([nl, 2]; exact and
    grid backends), the grid's sorted rows assembled by ``gather``."""
    _check_backend(cfg)
    if cfg.repulsion == "grid_dense":
        return _grid_repulsion(pos, mass, cfg)
    if cfg.repulsion in ("grid", "grid_pallas"):
        out = grid_ops.grid_repulsion(
            pos, mass, cfg.repulsion_k, cfg.grid_size, cfg.grid_window,
            cell=cell, order=order, rows=rows, gather=gather,
        )
        return out if rows is None else out[rows[0]:rows[0] + rows[1]]
    r = radii if cfg.use_radii else None
    if rows is None:
        return repulsion_ops.repulsion(pos, mass, cfg.repulsion_k, radii=r)
    return repulsion_ops.repulsion_rows(pos, mass, rows[0], rows[1], cfg.repulsion_k,
                                        radii=r)


def _apply_speed(state, f, mass, cfg: FA2Config):
    """FA2 speed controller (Algorithm 1): swing/traction → displacement.

    Returns the updated ``(pos, f, global_speed)`` state and the trace row
    ``[g_swing, g_traction, global_speed]``.
    """
    pos, prev_force, global_speed = state
    swing = torch.linalg.vector_norm(f - prev_force, dim=-1)
    traction = 0.5 * torch.linalg.vector_norm(f + prev_force, dim=-1)
    g_swing = torch.sum(mass * swing) + 1e-9
    g_traction = torch.sum(mass * traction)
    new_gs = cfg.jitter_tolerance * g_traction / g_swing
    global_speed = torch.minimum(new_gs, 1.5 * global_speed + 1e-3)

    fmag = torch.linalg.vector_norm(f, dim=-1)
    local_speed = global_speed / (1.0 + global_speed * torch.sqrt(swing))
    # FA2 caps node displacement: speed ≤ 10 / |f|.
    local_speed = torch.minimum(local_speed, 10.0 / torch.clamp(fmag, min=1e-9))
    pos = pos + local_speed[:, None] * f
    row = torch.stack([g_swing, g_traction, global_speed])
    return (pos, f, global_speed), row


def _apply_speed_guarded(state, f, mass, cfg: FA2Config):
    """``_apply_speed`` behind the divergence sentinel.

    With ``cfg.nan_guard`` off this IS ``_apply_speed``. With it on, a
    non-finite force array keeps positions and controller memory, halves
    the global speed, and traces ``[-1, -1, damped_speed]`` — selected on
    the device, with no host read.
    """
    if not cfg.nan_guard:
        return _apply_speed(state, f, mass, cfg)
    pos, prev_force, global_speed = state
    ok = torch.isfinite(f).all()
    (new_pos, new_f, new_gs), row = _apply_speed(state, f, mass, cfg)
    damped = 0.5 * global_speed
    neg = -torch.ones((), dtype=damped.dtype, device=damped.device)
    rec_row = torch.stack([neg, neg, damped])
    return (
        (torch.where(ok, new_pos, pos), torch.where(ok, new_f, prev_force),
         torch.where(ok, new_gs, damped)),
        torch.where(ok, row, rec_row),
    )


def recovery_count(trace) -> int:
    """Number of iterations the ``nan_guard`` sentinel rolled back in a
    ``layout``/``step`` trace (negative-g_swing rows)."""
    if isinstance(trace, torch.Tensor):
        trace = trace.detach().cpu().numpy()
    return int((np.asarray(trace)[:, 0] < 0).sum())


def step(state, edges, weights, mass, radii, cfg: FA2Config, n: int,
         cell=None, order=None):
    """One FA2 iteration (Algorithm 1 body): forces → speeds → displacement.

    For the grid backends, ``(cell, order)`` from ``kernels/grid.bin_and_sort``
    skip the per-call re-bin and sort (a caller of repeated steps refreshes
    them every ``cfg.grid_rebuild`` steps, as ``layout`` does). Returns
    ``(state, trace_row)``."""
    pos = state[0]
    f = _gravity(pos, mass, cfg)
    f = f + _attraction(pos, edges, weights, n)
    f = f + _repulsion_forces(pos, mass, radii, cfg, cell=cell, order=order)
    return _apply_speed_guarded(state, f, mass, cfg)


def _layout_inputs(edges, weights, mass, n: int, cfg: FA2Config, pos0, device):
    """``(mass, pos, radii, (dst, w2, layout))`` on ``device`` in the
    layout's type: initial positions, radii √mass and the source-sorted
    edges with their sources' segment layout."""
    dtype = getattr(torch, cfg.dtype)
    edges = torch.as_tensor(edges, device=device)
    weights = torch.as_tensor(weights, device=device).to(dtype)
    mass = torch.as_tensor(mass, device=device)
    if pos0 is None:  # from the mass as given, as the reference starts
        pos0 = initial_positions(edges, mass, n, cfg)
    mass = mass.to(dtype)
    pos = torch.as_tensor(pos0, device=device).to(dtype)
    radii = torch.sqrt(torch.clamp(mass, min=0.0))  # paper: radius ∝ √size
    return mass, pos, radii, _attraction_edge_layout(edges, weights, n)


def force_pass(mass, radii, dst, w2, src_layout, n: int, cfg: FA2Config, mesh=None):
    """``forces(pos, it)``: one iteration's full [n, 2] force array (gravity,
    attraction, repulsion), carrying the grid state (cell ids, cell-sorted
    order) between calls and rebuilding it every ``cfg.grid_rebuild``
    iterations.

    With a ``mesh`` of D ranks (n divisible by D) rank r computes only the
    forces on its nodes ``[r·n/D, (r+1)·n/D)`` and one tiled all-gather per
    iteration assembles the array, which is then the same on every rank:
    * gravity — on the owned rows;
    * attraction — the full-size sorted sum, owned rows kept: each node's
      sum is the same chain of adds as in the single-rank run (K7's
      ``attraction_sum`` on the card, ``index_add_`` on the CPU, both in row
      order), so the owned rows are its bits. This work is replicated;
    * exact repulsion — the owned targets against all sources
      (``repulsion_rows``, kernel K2's row range);
    * grid repulsion — binning, the stable sort and the cell statistics
      (K7) replicated; the far field (K5) and near field (K6's row range)
      on the owned rows of the cell-sorted order, whose gathered rows are
      then unsorted (``grid_ops.grid_repulsion(rows=)``, a second
      all-gather).
    Every cross-rank step is a concatenation, never a float sum, so on the
    CPU the array is bitwise the single-rank one."""
    grid_state = cfg.repulsion in ("grid", "grid_pallas")
    state = {"cell": None, "order": None}
    if mesh is None or mesh.size == 1:
        rows, owned, gather = slice(None), None, None
    else:
        from repro_torch.sharding.collectives import all_gather_rows

        nl = n // mesh.size
        i0 = mesh.rank * nl
        rows, owned = slice(i0, i0 + nl), (i0, nl)

        def gather(x):
            return all_gather_rows(x, mesh)

    def forces(p, it):
        if grid_state and (cfg.grid_rebuild <= 1 or it % cfg.grid_rebuild == 0):
            state["cell"], state["order"] = grid_ops.bin_and_sort(p, cfg.grid_size)
        f = _gravity(p[rows], mass[rows], cfg)
        f = f + _attraction_sorted(p, dst, w2, src_layout)[rows]
        f = f + _repulsion_forces(p, mass, radii, cfg, cell=state["cell"],
                                  order=state["order"], rows=owned, gather=gather)
        return f if gather is None else gather(f)

    return forces


def _run(pos, mass, forces, cfg: FA2Config):
    """The iteration loop around ``forces``: the speed controller, the trace
    and the adaptive stop. Returns ``(positions, trace, iterations_run)``."""
    dtype, device = pos.dtype, pos.device
    state = (pos, torch.zeros_like(pos), torch.ones((), dtype=dtype, device=device))
    trace = torch.zeros((cfg.iterations, 3), dtype=dtype, device=device)
    adaptive = cfg.stop_tolerance > 0.0
    it_run = 0
    for it in range(cfg.iterations):
        state, row = _apply_speed_guarded(state, forces(state[0], it), mass, cfg)
        trace[it] = row
        it_run += 1
        if adaptive and it + 1 >= cfg.min_iterations:
            # row[0] < 0 marks a nan_guard recovery — never "converged".
            done = (row[0] >= 0) & (row[0] <= cfg.stop_tolerance * row[1])
            if bool(done):
                break
    return state[0], trace, it_run


def layout(edges, weights, mass, n: int, cfg: FA2Config, pos0=None, device=None):
    """Run up to ``cfg.iterations`` FA2 steps on ``device`` (None = CUDA).

    ``edges`` [E, 2] (padded slots = n), ``weights`` [E], ``mass`` [n]:
    tensors or arrays. Returns ``(positions [n,2], trace [iterations,3],
    iterations_run)``; trace rows are (g_swing, g_traction, global_speed),
    zero past ``iterations_run``.
    """
    _check_backend(cfg)
    device = resolve_device(device)
    with get_tracer().span(
        "fa2.layout", n=n, iterations=cfg.iterations,
        repulsion=cfg.repulsion, adaptive=cfg.stop_tolerance > 0.0,
    ):
        mass, pos, radii, att = _layout_inputs(edges, weights, mass, n, cfg, pos0, device)
        return _run(pos, mass, force_pass(mass, radii, *att, n, cfg), cfg)


# Node-partitioned multi-device layout (the reference's ``layout_sharded``):
# each rank owns n/D consecutive nodes and computes only their forces; one
# tiled all-gather per iteration reassembles the force array for the
# replicated speed controller (``force_pass``). The adaptive stop composes
# for free: the gathered forces, hence the converged flag, are the same on
# every rank, so every rank stops on the same iteration.

_FALLBACK_WARNED: set[str] = set()


def _warn_fallback(reason: str) -> None:
    """Warn once per distinct reason that a configured mesh disengaged."""
    if reason not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(reason)
        warnings.warn(
            f"layout_sharded: falling back to single-device layout ({reason})",
            UserWarning,
            stacklevel=3,
        )


def _sharded_fallback_reason(n: int, cfg: FA2Config, mesh) -> str | None:
    """Why a non-None mesh cannot engage, or None if it can (the
    reference's reasons, word for word)."""
    if mesh.size <= 1:
        return "mesh is trivial (1 device)"
    if n % mesh.size != 0:
        return f"n={n} does not divide evenly over {mesh.size} devices"
    if cfg.repulsion in ("grid_pallas", "grid_dense"):
        return f"repulsion={cfg.repulsion!r} has no sharded form"
    if cfg.repulsion == "grid" and cfg.dtype != "float32":
        return (
            f"the sharded grid path runs in float32 (kernels/grid is "
            f"float32-pinned) and has no dtype={cfg.dtype!r} form"
        )
    return None


def layout_sharded(edges, weights, mass, n: int, cfg: FA2Config, mesh, pos0=None,
                   device=None):
    """``layout`` with the force pass node-partitioned over ``mesh``
    (``force_pass``); every rank calls it with the same arguments and gets
    the same ``(positions, trace, iterations_run)``. ``device=None`` means
    the mesh's device.

    Falls back to ``layout`` — with a warn-once ``UserWarning`` naming the
    reason — when the mesh holds one rank, ``n`` does not divide by the
    rank count, the backend has no sharded form ("grid_pallas",
    "grid_dense"), or the grid backend is asked for a non-float32 dtype.
    ``mesh=None`` falls back silently: that is the caller opting out. The
    forces and positions are bitwise ``layout``'s on either device."""
    _check_backend(cfg)
    if device is None and mesh is not None:
        device = mesh.device
    if mesh is None:
        return layout(edges, weights, mass, n, cfg, pos0, device)
    reason = _sharded_fallback_reason(n, cfg, mesh)
    if reason is not None:
        _warn_fallback(reason)
        return layout(edges, weights, mass, n, cfg, pos0, device)
    device = resolve_device(device)
    with get_tracer().span(
        "fa2.layout_sharded", n=n, iterations=cfg.iterations,
        repulsion=cfg.repulsion, devices=mesh.size,
    ):
        mass, pos, radii, att = _layout_inputs(edges, weights, mass, n, cfg, pos0, device)
        return _run(pos, mass, force_pass(mass, radii, *att, n, cfg, mesh), cfg)
