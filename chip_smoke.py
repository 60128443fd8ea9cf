#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. card      — ``nvidia-smi`` name and power limit.
2. build     — compiles the four kernels from ``src/repro_torch/csrc``
               (one ``nvcc`` per source, all at once).
3. kernels   — each kernel against its plain PyTorch version on the card,
               on adversarial inputs and on synthetic inputs at main-path
               shapes: K1, K3, K4 bitwise, K2 within its tolerance.
4. main path — ``biggraphvis`` + ``BGVResult.render`` on a planted-partition
               graph at web-BerkStan's size (685,230 nodes, ≈ 6.6 M edges),
               with every launch counter set to 0 just before and read just
               after; wall time, stage times and peak memory are taken from
               this run, and the content of the image is checked. A second
               run of the same path records each kernel's inputs.
5. timing    — each kernel on the inputs the main path gave it (recorded
               in phase 4): held against its plain version again, and
               timed with CUDA events beside the plain version, one PyTorch
               library call where there is one, and its bound.
6. consistency — a 3,000-node graph through the port on the card and on
               the CPU: labels, supergraph and raster accumulators bitwise,
               positions within tolerance; the same graph from a ``.npy``
               file through the pinned staging ring, bitwise.

It then prints the ``kernels`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. It exits non-zero, printing no
result line, when CUDA is unavailable, when the port's sources are not
beside it, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The main path's graph: a planted partition at web-BerkStan's size
# (685,230 nodes, ≈ 6.6 M edges; src/repro/configs/biggraphvis.py:56-59).
NODES, COMMUNITIES, P_IN, P_OUT, SEED = 685_230, 200, 0.0051, 2.6e-6, 0
ITERATIONS = 100  # FA2 iterations, the default
REPS = 20  # back-to-back launches per CUDA-event timing

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate
# outside the tensor cores (a fused multiply-add counts as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Per pair: dx, dy (2); dx²+dy² (3); max ε² (1); sqrt (1); eff: d−ri−rj (2,
# radii only) and max ε (1); mi·mj (1); eff·d (1); divide (1); f += mag·dx,
# mag·dy (4). kr·mi is hoisted per node.
K2_OPS_PER_PAIR = {True: 17, False: 15}
# Per node i and axis: |f_kernel − f_plain| ≤ K2_TOL · Σ_j |f_ij|. Each pair
# force rounds identically in both, so only the order of the f32 sum over j
# differs. The kernel adds 256-node tile sums, erring by at most about
# (256 + n/256) · 2⁻²⁴ of Σ|f_ij| (3.1e-5 at n = 65,536, the largest
# s_layout); the plain version's 1,024-node chunks of tree sums err less.
K2_TOL = 1e-4
# Per (disk, pixel) pair inside the disk's bounding box: dx, dy (2);
# dx², dy² (2); add (1); compare with r² (1).
K4_OPS_PER_PAIR = 6

KERNELS = {
    "merge_scatter": {
        "source": "src/repro_torch/csrc/merge_scatter.cu",
        "replaces": "src/repro/kernels/merge/sorted_merge.py:96",
    },
    "repulsion_nbody": {
        "source": "src/repro_torch/csrc/repulsion_nbody.cu",
        "replaces": "src/repro/kernels/repulsion/nbody.py:84",
    },
    "count_scatter": {
        "source": "src/repro_torch/csrc/count_scatter.cu",
        "replaces": "src/repro/kernels/raster/splat.py:94",
    },
    "disk_accum": {
        "source": "src/repro_torch/csrc/disk_accum.cu",
        "replaces": "src/repro/kernels/raster/splat.py:167",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    yield
    log(f"phase {name} seconds {time.perf_counter() - t0:.3f}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back launches."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k2_row_scale(torch, pos, mass, kr: float, radii, chunk: int = 1024):
    """Σ_j |f_ij| per node and axis, [n, 2]: the scale of each row's
    summation error. Same per-pair arithmetic as the plain version."""
    from repro_torch.kernels.repulsion.ref import EPS

    r = radii if radii is not None else torch.zeros_like(mass)
    out = torch.zeros_like(pos)
    for j0 in range(0, pos.shape[0], chunk):
        pj, mj, rj = pos[j0:j0 + chunk], mass[j0:j0 + chunk], r[j0:j0 + chunk]
        dx = pos[:, 0:1] - pj[None, :, 0]
        dy = pos[:, 1:2] - pj[None, :, 1]
        d = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=EPS * EPS))
        eff = torch.clamp(d - r[:, None] - rj[None, :], min=EPS)
        mag = kr * mass[:, None] * mj[None, :] / (eff * d)
        out[:, 0] += (mag * dx).abs().sum(1)  # the self pair has dx = dy = 0
        out[:, 1] += (mag * dy).abs().sum(1)
    return out


def k2_compare(torch, got, want, scale):
    """(worst |Δf| / Σ|f_ij| over rows, max|Δf|, max|f|, median|f|)."""
    err = (got - want).abs()
    ratio = torch.where(scale > 0, err / scale, torch.where(err > 0, torch.inf, 0.0))
    mag = want.norm(dim=1)
    return (float(ratio.max()), float(err.max()), float(mag.max()),
            float(mag.median()))


# ------------------------------------------------------------- phase 3
def kernel_checks(torch, np):
    """Adversarial and main-path-sized synthetic inputs, kernel vs plain."""
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.kernels.merge.ref import merge_combine_ref, scatter_combine_ref
    from repro_torch.kernels.raster import ops as raster_ops
    from repro_torch.kernels.raster.ref import count_scatter_into_ref, disk_accum_ref
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.repulsion.ref import repulsion_chunked

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    i32max = np.iinfo(np.int32).max

    def same(name, got, want):
        for g, w in zip(got, want):
            check(torch.equal(g, w), f"{name}: kernel differs from plain version")

    # K1: merge of sorted deduped runs (full wrapper path) and raw scatter.
    def run_pair(s_cap, cap, c, ks, kc, dup=0):
        """A sorted state run of ``ks`` unique pairs and a sorted chunk run
        of ``kc`` pairs, ``dup`` of them already in the state."""
        a = rng.integers(0, s_cap - 1, 3 * (ks + kc) + 16)
        b = rng.integers(a + 1, s_cap)
        keys = rng.permutation(np.unique(a * s_cap + b))[: ks + kc]

        def run(k, size):
            k = np.sort(k)
            out = [np.full(size, s_cap, np.int32), np.full(size, s_cap, np.int32),
                   np.zeros(size, np.float32)]
            out[0][:len(k)] = k // s_cap
            out[1][:len(k)] = k % s_cap
            out[2][:len(k)] = rng.integers(1, 9, len(k))
            return out

        st = run(keys[:ks], cap)
        ch = run(np.concatenate([keys[ks:ks + kc - dup], keys[:dup]]), c)
        return [torch.as_tensor(x, device=dev) for x in st + ch], s_cap

    cases = [(16, 32, 16, 12, 8, 4), (16, 32, 16, 32, 16, 2), (16, 32, 16, 0, 0, 0),
             (64, 100, 24, 77, 20, 5), (1 << 16, 16, 8, 12, 6, 3),
             (65536, 262144, 65536, 200000, 40000, 15000)]
    for s_cap, cap, c, ks, kc, dup in cases:
        args, s_cap = run_pair(s_cap, cap, c, ks, kc, dup)
        same(f"K1 merge s_cap={s_cap} cap={cap}",
             merge_ops.merge_combine(*args, s_cap), merge_combine_ref(*args, s_cap))
    n = 5000
    pos = torch.as_tensor(rng.integers(-50, 4000, n).astype(np.int32), device=dev)
    pos[::7] = i32max
    a = torch.as_tensor(rng.integers(0, 99, n).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.integers(1, 4, n).astype(np.float32), device=dev)
    same("K1 raw scatter", merge_ops.scatter_combine(pos, a, a, w, 4000),
         scatter_combine_ref(pos, a, a, w, 4000))
    log("K1 merge_scatter: bitwise on 6 merges + raw scatter")

    # K2: ragged n, both radii settings, overlapping and coincident nodes in
    # a ±500 box, and a ±50,000 box where d > ri + rj for almost every pair.
    worst = 0.0
    for n, use_radii, half in ((1000, True, 500), (1000, False, 500), (8191, True, 500),
                               (16384, True, 500), (4096, True, 50_000),
                               (16384, True, 50_000)):
        p = torch.as_tensor(rng.uniform(-half, half, (n, 2)).astype(np.float32), device=dev)
        p[1] = p[0]  # coincident pair: d clamps to EPS
        m = torch.as_tensor(rng.integers(1, 2000, n).astype(np.float32), device=dev)
        m[-7:] = 0.0  # dead padding
        r = torch.sqrt(m) if use_radii else None
        got = rep_ops.repulsion(p, m, 80.0, radii=r)
        want = repulsion_chunked(p, m, 80.0, radii=r)
        ratio, err, fmax, fmed = k2_compare(torch, got, want,
                                            k2_row_scale(torch, p, m, 80.0, r))
        log(f"K2 n={n} radii={use_radii} box ±{half}: worst |Δf|/Σ|f_ij| {ratio}, "
            f"max|Δf| {err}, max|f| {fmax}, median|f| {fmed}")
        worst = max(worst, ratio)
        check(ratio <= K2_TOL, f"K2 n={n} radii={use_radii}: {ratio} > {K2_TOL}")
    log(f"K2 repulsion_nbody: worst |Δf_i|/Σ_j|f_ij| {worst} (tolerance {K2_TOL})")

    # K3: negatives, one hot pixel, all padding, main-path-sized splat.
    size = 11 * 1024 * 1024
    for kind in ("negatives", "one_pixel", "all_padding", "main"):
        n = 524288 if kind == "main" else 4096
        if kind == "negatives":
            p = rng.integers(-5, 300, n)
        elif kind == "one_pixel":
            p = np.full(n, 77)
        elif kind == "all_padding":
            p = np.full(n, i32max)
        else:
            p = rng.integers(0, size + 1000, n)
        p = torch.as_tensor(p.astype(np.int32), device=dev)
        inc = torch.as_tensor(rng.integers(1, 6, n).astype(np.int32), device=dev)
        base = torch.as_tensor(rng.integers(0, 3, size).astype(np.int32), device=dev)
        for incv in (inc, None):
            got = raster_ops.count_scatter_into(base.clone(), p, incv)
            want = count_scatter_into_ref(base.clone(), p, incv)
            check(torch.equal(got, want), f"K3 {kind}: kernel differs from plain")
    log("K3 count_scatter: bitwise on 4 cases × 2 increment forms")

    # K4: one pixel, zero extent, all dead, random incl. bad groups, 1024².
    for kind in ("one_pixel", "zero_extent", "all_dead", "random", "main"):
        n, h, wd = 96, 24, 40
        g = rng.integers(0, 11, n)
        if kind == "one_pixel":
            cx, cy, r = np.full(n, 13.4), np.full(n, 7.2), rng.uniform(0.5, 0.6, n)
        elif kind == "zero_extent":
            cx, cy, r = np.full(n, 20.0), np.full(n, 12.0), rng.uniform(0, 6, n)
        elif kind == "all_dead":
            cx, cy, r = rng.uniform(0, wd, n), rng.uniform(0, h, n), -rng.uniform(0, 2, n)
        else:
            n, h, wd = (300, 60, 100) if kind == "random" else (64, 1024, 1024)
            cx = rng.uniform(-10, wd + 10, n)
            cy = rng.uniform(-10, h + 10, n)
            r = rng.uniform(-2, 40 if kind == "random" else 128, n)
            g = rng.integers(-2, 13, n)
        t = [torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (cx, cy, r)]
        gt = torch.as_tensor(np.asarray(g, np.int32), device=dev)
        got = raster_ops.disk_accum(*t, gt, 11, h, wd)
        want = disk_accum_ref(*t, gt, 11, h, wd)
        check(torch.equal(got, want), f"K4 {kind}: kernel differs from plain")
    log("K4 disk_accum: bitwise on 5 cases")
    torch.cuda.synchronize()


# ------------------------------------------------------------- phase 4
class Capture:
    """Records, per kernel wrapper, the largest call the main path makes
    (inputs cloned before the call), by wrapping the module attribute the
    callers look up. Launch counts stay with the wrappers themselves
    (``repro_torch.kernels.build.LAUNCHES``)."""

    def __init__(self, torch):
        from repro_torch.kernels import build
        from repro_torch.kernels.merge import ops as merge_ops
        from repro_torch.kernels.raster import ops as raster_ops
        from repro_torch.kernels.repulsion import ops as rep_ops

        self.torch = torch
        self.launches = build.LAUNCHES
        self.sites = [
            (merge_ops, "scatter_combine", "merge_scatter"),
            (rep_ops, "repulsion", "repulsion_nbody"),
            (raster_ops, "count_scatter_into", "count_scatter"),
            (raster_ops, "disk_accum", "disk_accum"),
        ]
        self.calls = {}

    def fn(self, name):
        mod, attr = next((m, a) for m, a, k in self.sites if k == name)
        return getattr(mod, attr)

    def counts(self):
        return dict(self.launches)

    def reset(self):
        for k in self.launches:
            self.launches[k] = 0

    @contextlib.contextmanager
    def recording(self):
        saved = []
        for mod, attr, key in self.sites:
            real = getattr(mod, attr)

            def wrapper(*args, _real=real, _key=key, **kw):
                size = args[0].numel() if _key != "count_scatter" else args[1].numel()
                best = self.calls.get(_key)
                if best is None or size > best[0]:
                    cl = tuple(x.clone() if isinstance(x, self.torch.Tensor) else x
                               for x in args)
                    self.calls[_key] = (size, cl, dict(kw))
                return _real(*args, **kw)

            saved.append((mod, attr, real))
            setattr(mod, attr, wrapper)
        try:
            yield
        finally:
            for mod, attr, real in saved:
                setattr(mod, attr, real)


def main_path(torch, np, cap: Capture):
    """Drives the main path twice on one graph. The first run is the one
    measured: launch counts, wall time, stage times, peak memory and the
    image checks. The second records each kernel's main-path inputs for the
    timing phase, so the copies it takes stay out of the first run's
    numbers."""
    import repro_torch
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree
    from repro_torch.render import raster
    from repro_torch.render.png import read_png

    t0 = time.perf_counter()
    edges, _ = planted_partition(NODES, COMMUNITIES, P_IN, P_OUT, seed=SEED)
    n, e = NODES, len(edges)
    delta = mode_degree(edges, n)
    log(f"graph: {n} nodes, {e} edges, mode degree {delta}, "
        f"host seconds {time.perf_counter() - t0:.3f}")
    cfg = repro_torch.default_config(n, e, delta, iterations=ITERATIONS)
    scfg = repro_torch.StreamConfig(chunk_size=1 << 16)

    def drive(png):
        res = repro_torch.biggraphvis(edges, n, cfg, scfg, device="cuda")
        image, rstats = res.render(png)
        return res, image, rstats

    with tempfile.TemporaryDirectory() as tmp:
        png = str(Path(tmp) / "main.png")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cap.reset()
        t0 = time.perf_counter()
        res, image, rstats = drive(png)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cap.counts()
        peak = torch.cuda.max_memory_allocated()
        check(np.array_equal(read_png(png), image), "PNG round trip differs")
        with cap.recording():
            rec, rec_image, _ = drive(png)
        torch.cuda.synchronize()
    # Labels and the supergraph are deterministic; positions are not quite
    # (the attraction's float index_add_ runs on atomics).
    check(np.array_equal(rec.labels, res.labels)
          and rec.n_superedges == res.n_superedges and rec_image.shape == image.shape,
          "recording run differs from the measured run")
    n_sn = res.n_supernodes
    s_layout = min(max(1 << (max(n_sn, 2) - 1).bit_length(), 64), cfg.s_cap)
    log(f"n_supernodes {n_sn} n_superedges {res.n_superedges} s_layout {s_layout} "
        f"modularity {res.modularity}")
    log("stage seconds " + json.dumps({
        **{k: v for k, v in res.timings.items()},
        "node_raster_s": rstats.node_raster_s, "edge_raster_s": rstats.edge_raster_s,
        "compose_s": rstats.compose_s, "main_path_wall_s": wall,
    }))
    log(f"max_memory_allocated bytes {peak}")
    log("main path launches " + json.dumps(launches))
    check(np.isfinite(res.positions).all(), "non-finite positions")
    frac, counts = raster.image_summary(image)
    log(f"image non-background fraction {frac}, palette colors {(counts > 0).sum()}")
    check(frac >= 0.01, f"image is {frac:.4f} non-background (< 1%)")
    check((counts > 0).sum() >= 3, "image shows fewer than 3 palette colors")
    if launches["disk_accum"] == 0:
        # No disk wider than 8 px on this graph: drive K4 on a scene of
        # large disks, as its own path with its own counts.
        cap.reset()
        rs = np.random.default_rng(1)
        with cap.recording():
            raster.render_arrays(rs.uniform(-1, 1, (64, 2)), rs.uniform(0.05, 0.2, 64),
                                 rs.integers(0, 11, 64), device="cuda")
        torch.cuda.synchronize()
        launches["disk_accum"] = cap.counts()["disk_accum"]
        log(f"large-disk scene launches {cap.counts()}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    return launches, s_layout


# ------------------------------------------------------------- phase 5
def time_kernels(torch, np, cap: Capture, launches):
    from repro_torch.kernels.merge.ref import scatter_combine_ref
    from repro_torch.kernels.raster.ref import count_scatter_into_ref, disk_accum_ref
    from repro_torch.kernels.repulsion.ref import repulsion_chunked

    rows = []

    def row(name, ms, plain_ms, lib_ms, err, bytes_, ops, shape):
        bound_b = bytes_ / PEAK_BYTES_PER_S * 1e3
        bound_o = ops / PEAK_F32_PER_S * 1e3
        r = {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "library_ms": lib_ms,
        }
        rows.append(r)
        log(f"{name} {shape}: ms {ms} plain_ms {plain_ms} library_ms {lib_ms} "
            f"bound_ms {r['bound_ms']} ({r['bound_by']}: bytes {bound_b} ms, "
            f"operations {bound_o} ms) max_abs_err {err}")

    # K1. The library yardstick runs on the kept rows only (filtered
    # outside the timed span): sending dropped rows to one scratch slot
    # would serialise the library's scatter on that slot.
    _, (pos, a, b, w, capn), _ = cap.calls["merge_scatter"]
    k1 = cap.fn("merge_scatter")
    got, want = k1(pos, a, b, w, capn), scatter_combine_ref(pos, a, b, w, capn)
    check(all(torch.equal(g, x) for g, x in zip(got, want)), "K1 differs on main-path input")
    keep = (pos >= 0) & (pos < capn)
    idx, a_k, b_k, w_k = pos[keep].long(), a[keep], b[keep], w[keep]
    oa = torch.full((capn,), -1, dtype=torch.int32, device=pos.device)
    ob, ow = oa.clone(), torch.zeros(capn, device=pos.device)

    def lib1():
        oa.scatter_reduce_(0, idx, a_k, "amax", include_self=True)
        ob.scatter_reduce_(0, idx, b_k, "amax", include_self=True)
        ow.index_put_((idx,), w_k, accumulate=True)

    nrow = pos.numel()
    row("merge_scatter",
        cuda_ms(torch, lambda: k1(pos, a, b, w, capn), REPS),
        cuda_ms(torch, lambda: scatter_combine_ref(pos, a, b, w, capn), REPS),
        cuda_ms(torch, lib1, REPS), 0.0,
        nrow * 16 + capn * 12, nrow, f"N={nrow} kept={idx.numel()} cap={capn}")

    # K2, held per row against Σ_j |f_ij|.
    _, (p, m, kr), kw = cap.calls["repulsion_nbody"]
    radii = kw.get("radii")
    k2 = cap.fn("repulsion_nbody")
    fk = k2(p, m, kr, radii=radii)
    fr = repulsion_chunked(p, m, kr, radii=radii)
    ratio, err, fmax, fmed = k2_compare(torch, fk, fr, k2_row_scale(torch, p, m, kr, radii))
    log(f"K2 main-path worst |Δf|/Σ|f_ij| {ratio}, max|Δf| {err}, max|f| {fmax}, "
        f"median|f| {fmed}")
    check(ratio <= K2_TOL, f"K2 main-path error {ratio} > {K2_TOL} of Σ|f_ij|")
    n2 = p.shape[0]
    row("repulsion_nbody",
        cuda_ms(torch, lambda: k2(p, m, kr, radii=radii), REPS),
        cuda_ms(torch, lambda: repulsion_chunked(p, m, kr, radii=radii), 2),
        None, err, n2 * 24, K2_OPS_PER_PAIR[radii is not None] * n2 * n2,
        f"n={n2} radii={radii is not None}")

    # K3. The library yardstick runs on the kept rows only, as for K1.
    _, (acc0, pos3, inc3), _ = cap.calls["count_scatter"]
    k3 = cap.fn("count_scatter")
    got = k3(acc0.clone(), pos3, inc3)
    want = count_scatter_into_ref(acc0.clone(), pos3, inc3)
    check(torch.equal(got, want), "K3 differs on main-path input")
    size = acc0.numel()
    keep = (pos3 >= 0) & (pos3 < size)
    hit = int(torch.unique(pos3[keep]).numel())
    acc_k, acc_p, acc_l = acc0.clone(), acc0.clone(), acc0.clone()
    idx3 = pos3[keep].long()
    inc_l = inc3[keep] if inc3 is not None else torch.ones_like(idx3, dtype=torch.int32)
    row("count_scatter",
        cuda_ms(torch, lambda: k3(acc_k, pos3, inc3), REPS),
        cuda_ms(torch, lambda: count_scatter_into_ref(acc_p, pos3, inc3), REPS),
        cuda_ms(torch, lambda: acc_l.index_put_((idx3,), inc_l, accumulate=True), REPS),
        0.0, pos3.numel() * (8 if inc3 is not None else 4) + hit * 8, pos3.numel(),
        f"N={pos3.numel()} kept={idx3.numel()} size={size} distinct_hits={hit} "
        f"inc={inc3 is not None}")

    # K4. The function needs only the pixels inside each live disk's
    # bounding box (clipped to the image), so that is the operation count.
    _, (cx, cy, r, g, ng, h, wd), _ = cap.calls["disk_accum"]
    k4 = cap.fn("disk_accum")
    check(torch.equal(k4(cx, cy, r, g, ng, h, wd), disk_accum_ref(cx, cy, r, g, ng, h, wd)),
          "K4 differs on main-path input")
    n4 = cx.numel()
    live = (r > 0) & (g >= 0) & (g < ng)

    def span(c, lim):
        lo = torch.clamp(torch.ceil(c.double() - r.double()), min=0)
        hi = torch.clamp(torch.floor(c.double() + r.double()), max=lim - 1)
        return torch.clamp(hi - lo + 1, min=0)

    pairs = int((span(cx, wd) * span(cy, h))[live].sum())
    row("disk_accum",
        cuda_ms(torch, lambda: k4(cx, cy, r, g, ng, h, wd), REPS),
        cuda_ms(torch, lambda: disk_accum_ref(cx, cy, r, g, ng, h, wd), 3),
        None, 0.0, n4 * 16 + ng * h * wd * 4, K4_OPS_PER_PAIR * pairs,
        f"n={n4} live={int(live.sum())} bbox_pairs={pairs} out={ng}x{h}x{wd}")
    return rows


# ------------------------------------------------------------- phase 6
def consistency(torch, np):
    import repro_torch
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree
    from repro_torch.render import raster

    n = 3000
    edges, _ = planted_partition(n, 30, 0.04, 0.0008, seed=0)
    cfg = repro_torch.default_config(n, len(edges), mode_degree(edges, n),
                                     iterations=4, init="degree")
    scfg = repro_torch.StreamConfig(chunk_size=4096)
    on = {d: repro_torch.biggraphvis(edges, n, cfg, scfg, device=d) for d in ("cuda", "cpu")}
    g, c = on["cuda"], on["cpu"]
    check(np.array_equal(g.labels, c.labels), "labels differ cuda/cpu")
    for f in ("edges", "weights", "sizes", "n_supernodes", "n_superedges", "labels"):
        check(torch.equal(getattr(g.supergraph, f).cpu(), getattr(c.supergraph, f)),
              f"supergraph.{f} differs cuda/cpu")
    check(abs(g.modularity - c.modularity) <= 1e-6, "modularity differs cuda/cpu")
    # A disk-backed source goes through the pinned staging ring too.
    from repro_torch.data.edge_store import write_npy

    with tempfile.TemporaryDirectory() as tmp:
        path = write_npy(Path(tmp) / "edges.npy", edges)
        d = repro_torch.biggraphvis(path, n, cfg, repro_torch.StreamConfig(
            chunk_size=1024, prefetch=2), device="cuda")
    check(np.array_equal(d.labels, c.labels), "disk-source labels differ")
    for f in ("edges", "weights", "sizes"):
        check(torch.equal(getattr(d.supergraph, f).cpu(), getattr(c.supergraph, f)),
              f"disk-source supergraph.{f} differs")
    scale = float(np.abs(c.positions).max())
    perr = float(np.abs(g.positions - c.positions).max())
    check(perr <= 1e-4 * scale, f"positions differ cuda/cpu by {perr} (> 1e-4·{scale})")
    # Raster accumulators from the CPU run's pixel coordinates.
    hs, ws = 512, 512
    pos = c.positions
    radii = np.sqrt(np.maximum(c.sizes, 0.0)).astype(np.float32)
    alive = radii > 0
    sc, ox, oy = raster._fit_transform(pos[alive], ws, hs, 0.04)
    px = ((pos[:, 0] - ox) * sc + ws / 2.0).astype(np.float32)
    py = (hs / 2.0 - (pos[:, 1] - oy) * sc).astype(np.float32)
    r_px = np.where(alive, np.clip(radii * sc, 1.0, 64.0), 0.0).astype(np.float32)
    r_px[:4] = [9.5, 20.0, 33.25, 60.0]
    groups = c.groups.astype(np.int32)
    acc = {d: raster._node_pass(px, py, r_px, groups, 11, hs, ws, torch.device(d)).cpu()
           for d in ("cuda", "cpu")}
    check(torch.equal(acc["cuda"], acc["cpu"]), "node raster differs cuda/cpu")
    pxy = np.concatenate([np.stack([px, py], 1), [[0.0, 0.0]]]).astype(np.float32)
    gext = np.concatenate([groups, [0]]).astype(np.int32)
    sedges = c.supergraph.edges
    eacc = {}
    for d in ("cuda", "cpu"):
        a = torch.zeros(11 * hs * ws, dtype=torch.int32, device=d)
        raster._edge_splat_update(a, sedges.to(d), torch.as_tensor(pxy, device=d),
                                  torch.as_tensor(gext, device=d), None, hs, ws, 8, 11)
        eacc[d] = a.cpu()
    check(torch.equal(eacc["cuda"], eacc["cpu"]), "edge raster differs cuda/cpu")
    log(f"consistency: {c.n_supernodes} supernodes, {c.n_superedges} superedges; "
        f"labels/supergraph/raster bitwise (in-memory and .npy sources), "
        f"positions max|Δ| {perr} of {scale}")


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on a GPU",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")  # TF32 off
    with phase("card"):
        smi = nvidia_smi_line()
        log(smi)
        log(f"python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    with phase("build"):
        for name, res in build.build().items():
            ptx = [ln.strip() for ln in res.log.splitlines()
                   if "registers" in ln or "spill" in ln]
            log(f"built {name} in {res.seconds:.3f} s: " + " | ".join(ptx))
    with phase("kernels"):
        kernel_checks(torch, np)
    cap = Capture(torch)
    with phase("main path"):
        launches, _ = main_path(torch, np, cap)
    with phase("timing"):
        rows = time_kernels(torch, np, cap, launches)
    cap.calls.clear()
    torch.cuda.empty_cache()
    with phase("consistency"):
        consistency(torch, np)
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    try:
        return run()
    except Exception:  # report any phase's failure, and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
