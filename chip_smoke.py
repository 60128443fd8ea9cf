#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. card      — ``nvidia-smi`` name and power limit.
2. build     — compiles the eight kernels from ``src/repro_torch/csrc``
               (one ``nvcc`` per source, all at once), prints each one's
               registers and fails if one spills.
3. kernels   — each kernel against its plain PyTorch version on the card,
               on adversarial inputs and on synthetic inputs at the paths'
               shapes: K1, K3, K4, K6, K8 bitwise, K2 and K5 within their
               tolerances and bitwise run to run (K2 also near contact,
               where eff = d − ri − rj cancels), K7 bitwise against its
               plain version on the CPU, within its bound of the one on the
               card, and bitwise run to run.
4. main path — ``biggraphvis`` + ``BGVResult.render`` on a planted-partition
               graph at web-BerkStan's size (685,230 nodes, ≈ 6.6 M edges),
               with every launch counter set to 0 just before and read just
               after; wall time, stage times and peak memory are taken from
               this run, and the content of the image is checked. A second
               run of the same path records each kernel's inputs.
5. full path — ``full_layout_colored`` (grid repulsion, 500 iterations) +
               ``render_arrays`` over every edge, on the same graph, with the
               counters set to 0 just before and read just after: stage
               times, wall, peak memory, the image and the layout's quality
               against its initial positions. One more iteration from the
               final layout records K5–K7's inputs.
6. timing    — each kernel on the inputs its path gave it (recorded in
               phases 4 and 5): held against its plain version again, and
               timed with CUDA events beside the plain version, one PyTorch
               library call where there is one, and its bound.
7. consistency — a 3,000-node graph through ``biggraphvis`` and an
               8,000-node graph through ``full_layout_colored`` on the card
               and on the CPU: labels, groups, supergraph, cell ids and
               raster accumulators bitwise, positions within tolerance; the
               3,000-node graph from a ``.npy`` file through the pinned
               staging ring, bitwise.

It then prints the ``kernels`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. It exits non-zero, printing no
result line, when CUDA is unavailable, when the port's sources are not
beside it, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
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
# The full path: the reference's and the paper's full-graph iteration count,
# and the grid of default_config.
FULL_ITERATIONS, GRID, WINDOW = 500, 64, 32
REPS = 20  # back-to-back launches per CUDA-event timing
QUEUE_CYCLES = 100_000_000  # ≈ 50 ms of device sleep ahead of each timing

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate
# outside the tensor cores (a fused multiply-add counts as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Per pair: dx, dy (2); dx²+dy² (3); max ε² (1); sqrt (1); eff: d−ri−rj (2,
# radii only) and max ε (1); mi·mj (1); eff·d (1); divide (1); f += mag·dx,
# mag·dy (4). kr·mi is hoisted per node.
K2_OPS_PER_PAIR = {True: 17, False: 15}
# Per node i and axis: |f_kernel − f_plain| ≤ K2_TOL · Σ_j |f_ij|. Both
# compute d², d and eff with the same roundings (near contact eff cancels,
# so the kernel keeps them exact); the kernel's approximate reciprocal
# (≤ 2⁻²³) and its hoisting of kr·m_i move each pair force by a few ulp.
# It adds 256-source tile sums, then a slice's tiles, then the S slices:
# at most about (8 + 256 + T/S + S) · 2⁻²⁴ of Σ|f_ij| (1.9e-5 at n = 65,536,
# the largest s_layout), and the plain version's 1,024-source chunks of
# tree sums err less.
K2_TOL = 1e-4
# Per (disk, pixel) pair inside the disk's bounding box: dx, dy (2);
# dx², dy² (2); add (1); compare with r² (1).
K4_OPS_PER_PAIR = 6
# Per (node, cell) pair: dx, dy (2); dx², dy² and their sum (3); max EPS2
# (1); ·M_j (1, kr·m_i hoisted); divide (1); own-cell select (1); mag·dx,
# mag·dy (2); the two tile-sum adds (2).
K5_OPS_PER_PAIR = 13
# Per node and axis: |f_kernel − f_plain| ≤ K5_TOL · Σ_j |f_ij|. The
# kernel fuses d² into an FMA (≤ 1 ulp), takes an approximate reciprocal
# (≤ 2⁻²³) and applies kr·m_i once per node, so each pair force differs by
# a few ulp; it adds 256-cell tile sums, erring by at most about
# (12 + 256 + C/256) · 2⁻²⁴ of Σ|f_ij| (1.7e-5 at C = 4,096), and the plain
# version's tree sum over the C cells less.
K5_TOL = 1e-4
# K6: one compare per in-range band slot, and per same-cell pair dx, dy (2);
# dx², dy², sum (3); max (1); ·m_j (1); divide (1); mag·dx, mag·dy (2);
# two adds (2).
K6_OPS_PER_PAIR = 12
# The layouts of src/repro_torch/csrc/near_field.cu (sorted nodes a block,
# the window with its own kernel) and segment_sum.cu (floats a warp stages
# at a time), for the edge cases.
K6_BLOCK_NODES, K6_FIXED_WINDOW = 512, 32
K7_CHUNK_FLOATS = 1024

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
    "far_field": {
        "source": "src/repro_torch/csrc/far_field.cu",
        "replaces": "src/repro/kernels/grid/tiled.py:96",
    },
    "near_field": {
        "source": "src/repro_torch/csrc/near_field.cu",
        "replaces": "src/repro/kernels/grid/tiled.py:188",
    },
    "segment_sum": {
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment/seg_matmul.py:60",
    },
    "cms_update": {
        "source": "src/repro_torch/csrc/cms_update.cu",
        "replaces": "src/repro/kernels/cms/cms_update.py:64",
    },
}
MAIN_KERNELS = ("merge_scatter", "repulsion_nbody", "count_scatter", "disk_accum")
FULL_KERNELS = ("far_field", "near_field", "segment_sum")  # one launch per iteration
NO_LIBRARY = "none: no single PyTorch call computes it"


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
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back launches. A
    sleep kernel holds the stream while the host queues the launches, so a
    kernel shorter than its wrapper's host time is timed on the device, not
    at the host's launch rate."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
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


def k5_row_scale(torch, pos, mass, cell, ccent, cmass, kr: float, nb: int = 1024):
    """Σ_j |f_ij| per node and axis of the far field, [n, 2]: the scale of
    each row's summation error. Same per-pair arithmetic as the plain
    version."""
    from repro_torch.kernels.grid.ref import EPS2

    cells = torch.arange(ccent.shape[0], device=pos.device)[None, :]
    out = torch.empty_like(pos)
    for i0 in range(0, pos.shape[0], nb):
        p, m, c = pos[i0:i0 + nb], mass[i0:i0 + nb], cell[i0:i0 + nb]
        dx = p[:, 0:1] - ccent[None, :, 0]
        dy = p[:, 1:2] - ccent[None, :, 1]
        mag = kr * m[:, None] * cmass[None, :] / torch.clamp(dx * dx + dy * dy, min=EPS2)
        mag = torch.where(c[:, None] == cells, 0.0, mag)
        out[i0:i0 + nb, 0] = (mag * dx).abs().sum(1)
        out[i0:i0 + nb, 1] = (mag * dy).abs().sum(1)
    return out


def k7_check(torch, name, data, seg, n_seg, sorted_ids):
    """K7 against its plain version: bitwise on the CPU (the same row order
    and roundings), bitwise run to run, and on the card within the bound
    2·γ(k−1)·Σ|x| per segment of k rows, γ(m) = m·u / (1 − m·u), u = 2⁻²⁴
    (two sums of the same terms in any two orders). Returns the worst
    |Δ| / bound against the card's plain version."""
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import segment_sum_ref

    got = seg_ops.segment_sum(data, seg, n_seg, indices_are_sorted=sorted_ids)
    again = seg_ops.segment_sum(data, seg, n_seg, indices_are_sorted=sorted_ids)
    check(torch.equal(got, again), f"K7 {name}: two launches differ")
    cpu = segment_sum_ref(data.cpu(), seg.cpu(), n_seg)
    check(torch.equal(got.cpu(), cpu), f"K7 {name}: differs from the plain version on the CPU")
    plain = segment_sum_ref(data, seg, n_seg)
    keep = (seg >= 0) & (seg < n_seg)
    idx = seg[keep].long()
    k = torch.zeros(n_seg, dtype=torch.float64, device=data.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.float64))
    absum = torch.zeros((n_seg,) + tuple(data.shape[1:]), dtype=torch.float64,
                        device=data.device).index_add_(0, idx, data[keep].double().abs())
    m = torch.clamp(k - 1, min=0) * 2.0**-24
    bound = 2 * m / (1 - m)
    bound = bound.reshape((-1,) + (1,) * (data.dim() - 1)) * absum
    err = (got.double() - plain.double()).abs()
    check(bool((err <= bound).all()), f"K7 {name}: |Δ| above 2γ(k−1)·Σ|x| of the card's plain")
    ratio = torch.where(bound > 0, err / bound, torch.zeros_like(err))
    return float(ratio.max())


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

    # K2: ragged n (one node, one short of a node block, one past it, the
    # largest s_layout), both radii settings, overlapping and coincident
    # nodes in a ±500 box, a ±50,000 box where d > ri + rj for almost every
    # pair, and near contact (below). Two launches must give the same bits.
    def k2_case(name, p, m, r):
        got = rep_ops.repulsion(p, m, 80.0, radii=r)
        check(torch.equal(got, rep_ops.repulsion(p, m, 80.0, radii=r)),
              f"K2 {name}: two launches differ")
        want = repulsion_chunked(p, m, 80.0, radii=r)
        ratio, err, fmax, fmed = k2_compare(torch, got, want,
                                            k2_row_scale(torch, p, m, 80.0, r))
        log(f"K2 {name}: worst |Δf|/Σ|f_ij| {ratio}, max|Δf| {err}, max|f| {fmax}, "
            f"median|f| {fmed}")
        check(ratio <= K2_TOL, f"K2 {name}: {ratio} > {K2_TOL}")
        return ratio

    worst = 0.0
    for n, use_radii, half in ((1, True, 500), (255, True, 500), (257, False, 500),
                               (1000, True, 500), (1000, False, 500), (8191, True, 500),
                               (16384, True, 500), (4096, True, 50_000),
                               (16384, True, 50_000), (65536, True, 5_000)):
        p = torch.as_tensor(rng.uniform(-half, half, (n, 2)).astype(np.float32), device=dev)
        m = torch.as_tensor(rng.integers(1, 2000, n).astype(np.float32), device=dev)
        if n > 8:
            p[1] = p[0]  # coincident pair: d clamps to EPS
            m[-7:] = 0.0  # dead padding
        r = torch.sqrt(m) if use_radii else None
        worst = max(worst, k2_case(f"n={n} radii={use_radii} box ±{half}", p, m, r))
    # Near contact: 2,048 pairs 1,000 apart, the members of a pair 60–160
    # apart along an axis or a diagonal. rj is set from the pair's d as the
    # plain version computes it, so that d − ri − rj runs from a few ulp of
    # d (clamped to EPS) up to 1e-3: eff is tiny, one ulp of d would move
    # it by percent, and that pair dominates its row.
    k = 2048
    dist = rng.uniform(60.0, 160.0, k)
    ang = np.where(np.arange(k) % 2 == 0, 0.0, rng.uniform(0, 2 * np.pi, k))
    a = np.stack([np.zeros(k), np.arange(k) * 1000.0], 1)
    b = a + dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
    p = torch.as_tensor(np.concatenate([a, b]).astype(np.float32), device=dev)
    dxy = p[:k] - p[k:]
    d = torch.sqrt(torch.clamp(dxy[:, 0] * dxy[:, 0] + dxy[:, 1] * dxy[:, 1], min=1e-8))
    ri = d * torch.as_tensor(rng.uniform(0.2, 0.8, k).astype(np.float32), device=dev)
    gap = torch.as_tensor(np.geomspace(2e-5, 1e-3, k).astype(np.float32), device=dev)
    rr = torch.cat([ri, d - ri - gap])
    m = torch.as_tensor(rng.integers(100, 2000, 2 * k).astype(np.float32), device=dev)
    eff = d - rr[:k] - rr[k:]
    log(f"K2 near contact: d − ri − rj in [{float(eff.min())}, {float(eff.max())}], "
        f"{int((eff < 1e-4).sum())} of {k} pairs clamped to EPS")
    worst = max(worst, k2_case("near contact", p, m, rr))
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
    grid_kernel_checks(torch, np, rng)
    torch.cuda.synchronize()


def grid_kernel_checks(torch, np, rng):
    """K5–K8 against their plain versions on adversarial and full-shape
    inputs (the cases of the reference's kernel tests, and more)."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.cms.ref import cms_update_ref
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.kernels.grid.ref import bin_and_sort, far_field_ref, near_field_ref

    dev = torch.device("cuda")

    def sorted_grid(n, g, half, kind="random"):
        p = rng.uniform(-half, half, (n, 2)).astype(np.float32)
        if kind == "zero_extent":
            p[:] = p[0]
        elif kind == "clustered":  # a few dense clumps: heavy cells, empty cells
            p = (rng.standard_normal((n, 2)) * half / 50
                 + rng.integers(0, 5, (n, 1)) * half / 3).astype(np.float32)
        m = rng.integers(1, 300, n).astype(np.float32)
        pos = torch.as_tensor(p, device=dev)
        mass = torch.as_tensor(m, device=dev)
        cell, order = bin_and_sort(pos, g)
        o = order.long()
        return pos[o].contiguous(), mass[o].contiguous(), cell[o].contiguous()

    # K5: one cell, zero extent, empty cells (clumps), mass-0 padding with
    # cell −1, a spread-out box where no pair reaches the EPS2 clamp, a cell
    # count that is not a multiple of the 256-cell tile (G = 45), every
    # cell empty but the nodes' own (empty cells at random centroids), and
    # the full path's shape. Two launches must give the same bits.
    worst5 = 0.0
    cases5 = [("one_cell", 3000, 1, 500.0, "random"),
              ("zero_extent", 2000, 64, 500.0, "zero_extent"),
              ("clustered", 20000, 64, 500.0, "clustered"),
              ("padding", 5000, 64, 500.0, "random"),
              ("spread", 20000, 64, 5e6, "random"),
              ("ragged_cells", 20000, 45, 500.0, "random"),
              ("own_only", 5000, 64, 500.0, "random"),
              ("full_shape", NODES, GRID, 1e4, "clustered")]
    for name, n, g, half, kind in cases5:
        pos_s, mass_s, cell_s = sorted_grid(n, g, half, kind)
        ccent, cmass = grid_ops.cell_stats(pos_s, mass_s, cell_s, g * g)
        if name == "padding":  # dead rows after the stats: they must receive nothing
            mass_s[-300:] = 0.0
            cell_s[-300:] = -1
        if name == "own_only":  # all nodes in cell 1,234, the only one with mass
            cell_s[:] = 1234
            ccent = torch.as_tensor(rng.uniform(-500, 500, (g * g, 2)).astype(np.float32),
                                    device=dev)
            cmass = torch.zeros(g * g, device=dev)
            cmass[1234] = float(mass_s.sum())
        if name == "spread":
            p64, c64 = pos_s.double(), ccent.double()
            d2 = ((p64[:, 0:1] - c64[None, :, 0]) ** 2
                  + (p64[:, 1:2] - c64[None, :, 1]) ** 2)
            other = (cell_s[:, None] != torch.arange(g * g, device=dev)[None, :]) & (
                cmass[None, :] > 0)
            d2min = float(torch.where(other, d2, torch.inf).min())
            check(d2min > 1e-4, f"K5 spread case reaches the EPS2 clamp ({d2min})")
        got = grid_ops.far_field(pos_s, mass_s, cell_s, ccent, cmass, 80.0)
        check(torch.equal(got, grid_ops.far_field(pos_s, mass_s, cell_s, ccent, cmass, 80.0)),
              f"K5 {name}: two launches differ")
        want = far_field_ref(pos_s, mass_s, cell_s, ccent, cmass, 80.0)
        scale = k5_row_scale(torch, pos_s, mass_s, cell_s, ccent, cmass, 80.0)
        ratio, err, fmax, _ = k2_compare(torch, got, want, scale)
        if name in ("one_cell", "zero_extent", "own_only"):
            check(not got.any() and not want.any(), f"K5 {name}: forces not zero")
        if name == "padding":
            check(not got[-300:].any(), "K5 padding rows receive force")
        log(f"K5 {name} n={n} G={g}: worst |Δf|/Σ|f_ij| {ratio}, max|Δf| {err}, "
            f"max|f| {fmax}, empty cells {int((cmass == 0).sum())}")
        worst5 = max(worst5, ratio)
        check(ratio <= K5_TOL, f"K5 {name}: {ratio} > {K5_TOL}")
    log(f"K5 far_field: worst |Δf_i|/Σ_j|f_ij| {worst5} (tolerance {K5_TOL})")

    # K6: occupancy far above the window (one cell), window 0, window > n,
    # a window wider than one staged chunk of shifts, mass-0 padding, ties
    # (coincident nodes reach the EPS2 clamp), and the full path's shape.
    # Against the kernel's layout (K6_BLOCK_NODES nodes a block; W = 32
    # compiled apart, every other window generic): ragged tails at one and
    # two blocks ± 1 node, n < W, runs of one cell across every block edge,
    # W = 31 and 33 beside 32, edge and interior blocks in one launch, and
    # blocks whose masses or distances leave the range of its inline divide
    # (they take __fdiv_rn). The inline divide's range (divides_in_range in
    # near_field.cu: staged |x|, |y| <= 2^28, masses and kr·masses +0 or in
    # [2^-30, 2^30]) is held at its edges, at kr = 1 and 80: masses and
    # kr·masses at 2^-30 and 2^30 and with all-ones significands just
    # inside, coordinates at ±2^28 and just inside, coincident and distant
    # pairs (quotients from about 2^-119 to 2^73), every block on the inline
    # divide; and records just outside each bound, which send their blocks
    # to __fdiv_rn. Two launches give the same bits on every case.
    nb = K6_BLOCK_NODES
    f32 = np.float32

    def fast_blocks(pos, mass, kr, w):
        """(blocks whose staged records all pass divides_in_range and so
        take the inline divide, blocks), as near_field.cu decides it."""
        n = pos.shape[0]
        blocks = -(-n // nb)
        if min(w, n - 1) != K6_FIXED_WINDOW:  # the generic kernel: __fdiv_rn only
            return 0, blocks

        def moderate(v):
            u = v.contiguous().view(torch.int32)
            return (u == 0) | ((u >= 0x30800000) & (u <= 0x4E800000))

        ok = (pos.abs() <= 2.0**28).all(1) & moderate(mass) & moderate(mass * kr)
        bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         (~ok).long().cumsum(0)])
        b0 = torch.arange(0, n, nb, device=dev)
        span = bad[(b0 + nb + w).clamp(max=n)] - bad[(b0 - w).clamp(min=0)]
        return int((span == 0).sum()), blocks

    def range_input(n, kr, outside=False):
        """n records in runs of 37 a cell at the edges of the inline
        divide's range; with ``outside``, one record just beyond a bound in
        each of blocks 0, 1 and 3."""
        lo, hi, kr32 = f32(2.0**-30), f32(2.0**30), f32(kr)

        def inside(m):
            return lo <= m <= hi and lo <= kr32 * m <= hi

        def nearest_inside(v, toward):
            v = f32(v)
            while not inside(v):
                v = np.nextafter(v, f32(toward))
            return v

        masses = [nearest_inside(max(lo, lo / kr32), np.inf),
                  nearest_inside(min(hi, hi / kr32), -np.inf)]
        masses += [m for m in (f32((2 - 2**-23) * 2.0**-30), f32((2 - 2**-23) * 2.0**29),
                               f32(1), f32(3), f32(299)) if inside(m)]
        edge = f32(2.0**28)
        coords = np.array([edge, -edge, f32((2 - 2**-23) * 2.0**27),
                           -f32((2 - 2**-23) * 2.0**27), 0, 2.0**-10, -(2.0**-10)],
                          dtype=np.float32)
        p = rng.uniform(-(2.0**28), 2.0**28, (n, 2)).astype(np.float32)
        pick = rng.random((n, 2)) < 0.7
        p[pick] = rng.choice(coords, int(pick.sum()))
        m = rng.choice(np.array(masses, dtype=np.float32), n)
        if outside:
            p[5, 0] = np.nextafter(edge, f32(np.inf))
            m[nb + 300] = np.nextafter(lo, f32(0))
            m[3 * nb + 200] = np.nextafter(hi, f32(np.inf))
        return (torch.as_tensor(p, device=dev), torch.as_tensor(m, device=dev),
                torch.arange(n, dtype=torch.int32, device=dev) // 37)

    # Which blocks take the inline divide, where a case is about that.
    on_inline = {"range_kr1": "all", "range_kr80": "all", "range_outside": "some",
                 "tiny_masses": "some", "far_coords": "none"}
    range_kr = {"range_kr1": 1.0, "range_kr80": 80.0, "range_outside": 1.0}
    cases6 = [("one_cell", 5000, 1, 32), ("window_0", 3000, 16, 0),
              ("window_gt_n", 100, 1, 256), ("wide_window", 5000, 4, 600),
              ("padding", 4000, 8, 32), ("coincident", 3000, 8, 32),
              ("full_shape", NODES, GRID, WINDOW),
              ("block_minus_1", nb - 1, 4, 32), ("block", nb, 4, 32),
              ("block_plus_1", nb + 1, 4, 32),
              ("two_blocks_minus_1", 2 * nb - 1, 4, 32), ("two_blocks", 2 * nb, 4, 32),
              ("two_blocks_plus_1", 2 * nb + 1, 4, 32),
              ("n_lt_w", 20, 1, 32), ("straddle", 9 * nb + 77, 0, 32),
              ("straddle_w33", 9 * nb + 77, 0, 33),
              ("w31", 20000, 16, 31), ("w33", 20000, 16, 33),
              ("edge_and_interior", 4 * nb + 100, 8, 32),
              ("tiny_masses", 20000, 16, 32), ("far_coords", 5000, 8, 32),
              ("far_coords_w33", 5000, 8, 33),
              ("range_kr1", 4 * nb + 100, 0, 32), ("range_kr80", 4 * nb + 100, 0, 32),
              ("range_outside", 4 * nb + 100, 0, 32)]
    for name, n, g, w in cases6:
        kr = range_kr.get(name, 80.0)
        if name in range_kr:
            pos_s, mass_s, cell_s = range_input(n, kr, outside=name == "range_outside")
        elif g:
            pos_s, mass_s, cell_s = sorted_grid(n, g, 500.0, "clustered")
        else:  # runs of 37 nodes a cell: every block edge falls inside a run
            pos_s, mass_s, _ = sorted_grid(n, 4, 500.0, "clustered")
            cell_s = torch.arange(n, dtype=torch.int32, device=dev) // 37
        if name == "padding":
            mass_s[-100:] = 0.0
        if name == "coincident":
            pos_s[1::2] = pos_s[0::2][: pos_s[1::2].shape[0]]
        if name == "tiny_masses":  # a few blocks with a divide outside the fast range
            mass_s[3 * nb + 7::5 * nb] = 1e-38
        if name.startswith("far_coords"):  # d² above 2⁶⁰: every block off the fast range
            pos_s = pos_s * 1e9
        if name in on_inline:
            fast, blocks = fast_blocks(pos_s, mass_s, kr, w)
            log(f"K6 {name}: {fast} of {blocks} blocks take the inline divide")
            check({"all": fast == blocks, "some": 0 < fast < blocks,
                   "none": fast == 0}[on_inline[name]],
                  f"K6 {name}: {fast} of {blocks} blocks on the inline divide, "
                  f"expected {on_inline[name]}")
        got = grid_ops.near_field_sorted(pos_s, mass_s, cell_s, kr, w)
        check(torch.equal(got, grid_ops.near_field_sorted(pos_s, mass_s, cell_s, kr, w)),
              f"K6 {name}: two launches differ")
        want = near_field_ref(pos_s, mass_s, cell_s, kr, w)
        check(torch.equal(got, want), f"K6 {name}: kernel differs from plain version")
        if w == 0:
            check(not got.any(), "K6 window 0: forces not zero")
    log(f"K6 near_field: bitwise on {len(cases6)} cases, and run to run")

    # K7: negative and out-of-range ids (unsorted: the wrapper sorts), the
    # trash tail, one segment holding every row, all rows dropped, wide
    # rows, and the full path's cell statistics. Against the kernel's
    # layout (a warp per segment staging K7_CHUNK_FLOATS floats at a time,
    # 32 columns a pass): one segment far longer than a chunk at D = 3 and
    # D = 64, empty segments between occupied ones and at both ends, and
    # D = 1 through the wrapper's 1-D input.
    cases7 = (("out_of_range", 50000, 3, 4096), ("trash_tail", 50000, 3, 80),
              ("one_segment", 200000, 3, 16), ("all_dropped", 5000, 3, 16),
              ("wide_rows", 20000, 64, 50), ("full_shape", NODES, 3, GRID * GRID),
              ("long_segment", 60000, 3, 300), ("long_segment_wide", 6000, 64, 40),
              ("empty_gaps", 30000, 3, 500), ("one_column", 40000, 1, 200))
    worst7 = 0.0
    for name, e, d, n_seg in cases7:
        data = torch.as_tensor(rng.standard_normal((e, d)).astype(np.float32) * 1e3, device=dev)
        if name == "out_of_range":
            seg = rng.integers(-50, n_seg + 50, e)
        elif name == "one_segment":
            seg = np.full(e, 7)
        elif name == "all_dropped":
            seg = np.full(e, n_seg)
        elif name.startswith("long_segment"):  # segment 5 holds 10 chunks' worth of rows
            seg = rng.integers(0, n_seg, e)
            seg[: 10 * K7_CHUNK_FLOATS // d] = 5
            seg = np.sort(seg)
        elif name == "empty_gaps":  # only every third of segments 10 .. n − 11 is occupied
            seg = np.sort(rng.choice(np.arange(10, n_seg - 10, 3), e))
        else:
            seg = np.sort(rng.integers(0, n_seg, e))
            if name == "trash_tail":
                seg[-500:] = n_seg
        seg = torch.as_tensor(seg.astype(np.int32), device=dev)
        sorted_ids = name != "out_of_range"
        if name == "full_shape":
            pos_s, mass_s, seg = sorted_grid(e, GRID, 1e4, "clustered")
            data = torch.cat([pos_s * mass_s[:, None], mass_s[:, None]], 1)
        if name == "one_column":
            data = data[:, 0].contiguous()
        worst7 = max(worst7, k7_check(torch, name, data, seg, n_seg, sorted_ids))
    log(f"K7 segment_sum: bitwise on the CPU and run to run on {len(cases7)} cases; worst "
        f"|Δ| / 2γ(k−1)Σ|x| against the card's plain version {worst7}")

    # K8: integer weights (exact in any order), all padding, one hot
    # bucket, out-of-range buckets, float weights, the main path's shape.
    for name, rows, cols, n in (("random", 4, 512, 20000), ("all_padding", 4, 256, 3000),
                                ("one_bucket", 4, 64, 50000), ("out_of_range", 2, 100, 5000),
                                ("float_weights", 4, 6594, 100000),
                                ("main_shape", 4, 6594, NODES)):
        h = rng.integers(0, cols, (rows, n))
        h[:, ::7] = -1  # padding, in every row
        if name == "all_padding":
            h[:] = -1
        elif name == "one_bucket":
            h[:] = 3
        elif name == "out_of_range":
            h = rng.integers(-5, cols + 5, (rows, n))
        h = torch.as_tensor(h.astype(np.int32), device=dev)
        if name == "float_weights":
            w = torch.as_tensor(rng.uniform(0, 3, n).astype(np.float32), device=dev)
        else:
            w = torch.as_tensor(rng.integers(0, 60, n).astype(np.float32), device=dev)
        sketch = torch.as_tensor(rng.integers(0, 9, (rows, cols)).astype(np.float32),
                                 device=dev)
        got = cms_ops.update_hashed(sketch, h, w)
        want = cms_update_ref(sketch, h, w)
        if name == "float_weights":
            # Each bucket's sum of k terms in two orders: within
            # 2γ(k)·(|s0| + Σ|w|) of each other, γ(k) = k·u / (1 − k·u).
            keep = h >= 0
            r = torch.arange(rows, device=dev)[:, None].expand_as(h)[keep]
            b = h[keep].long()
            cnt = torch.ones_like(sketch, dtype=torch.float64).index_put_(
                (r, b), torch.ones_like(b, dtype=torch.float64), accumulate=True)
            absum = sketch.double().abs().index_put_(
                (r, b), w.double().abs()[None, :].expand_as(h)[keep], accumulate=True)
            m = cnt * 2.0**-24
            err = (got.double() - want.double()).abs()
            check(bool((err <= 2 * m / (1 - m) * absum).all()),
                  "K8 float weights: a bucket differs by more than 2γ(k)·Σ|x|")
        else:
            check(torch.equal(got, want), f"K8 {name}: kernel differs from plain version")
    cfg = cms_lib.CMSConfig(rows=4, cols=6594)
    keys = torch.as_tensor(rng.integers(-1, 200, NODES).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.integers(1, 50, NODES).astype(np.float32), device=dev)
    s0 = cms_lib.init_sketch(cfg, device=dev)
    check(torch.equal(cms_ops.update(s0, keys, w, cfg), cms_lib.update(s0, keys, w, cfg)),
          "K8 ops.update differs from core.cms.update")
    log("K8 cms_update: bitwise on 5 integer-weight cases and ops.update against "
        "core.cms.update; float weights within 2γ(k)·Σ|w|")


# ------------------------------------------------------------- phase 4
class Capture:
    """Records kernel inputs by wrapping the module attribute each caller
    looks up (inputs cloned before the call): per site the largest call,
    or the latest one for the grid path's sites, whose calls all have one
    size. Launch counts stay with the wrappers themselves
    (``repro_torch.kernels.build.LAUNCHES``). The CMS site is the main
    path's ``core.cms.update`` (an ``index_put_``): its input is K8's."""

    def __init__(self, torch):
        from repro_torch.core import cms as cms_lib
        from repro_torch.kernels import build
        from repro_torch.kernels.grid import ops as grid_ops
        from repro_torch.kernels.merge import ops as merge_ops
        from repro_torch.kernels.raster import ops as raster_ops
        from repro_torch.kernels.repulsion import ops as rep_ops
        from repro_torch.kernels.segment import ops as seg_ops

        self.torch = torch
        self.launches = build.LAUNCHES
        # (module, attribute, key, index of the argument whose size ranks
        # calls, keep the latest call)
        self.sites = [
            (merge_ops, "scatter_combine", "merge_scatter", 0, False),
            (rep_ops, "repulsion", "repulsion_nbody", 0, False),
            (raster_ops, "count_scatter_into", "count_scatter", 1, False),
            (raster_ops, "disk_accum", "disk_accum", 0, False),
            (grid_ops, "far_field", "far_field", 0, True),
            (grid_ops, "near_field_sorted", "near_field", 0, True),
            (seg_ops, "segment_sum", "segment_sum", 0, True),
            (cms_lib, "update", "cms_update", 1, False),
        ]
        self.calls = {}

    def fn(self, name):
        mod, attr = next((m, a) for m, a, k, _, _ in self.sites if k == name)
        return getattr(mod, attr)

    def counts(self):
        return dict(self.launches)

    def reset(self):
        for k in self.launches:
            self.launches[k] = 0

    @contextlib.contextmanager
    def recording(self):
        saved = []
        for mod, attr, key, arg, latest in self.sites:
            real = getattr(mod, attr)

            def wrapper(*args, _real=real, _key=key, _arg=arg, _latest=latest, **kw):
                size = args[_arg].numel()
                best = self.calls.get(_key)
                if best is None or size > best[0] or (_latest and size == best[0]):
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


def make_graph():
    """The graph both paths run on, generated once."""
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree

    t0 = time.perf_counter()
    edges, _ = planted_partition(NODES, COMMUNITIES, P_IN, P_OUT, seed=SEED)
    delta = mode_degree(edges, NODES)
    log(f"graph: {NODES} nodes, {len(edges)} edges, mode degree {delta}, "
        f"host seconds {time.perf_counter() - t0:.3f}")
    return edges, delta


def main_path(torch, np, cap: Capture, edges, delta):
    """Drives the main path twice on one graph. The first run is the one
    measured: launch counts, wall time, stage times, peak memory and the
    image checks. The second records each kernel's main-path inputs for the
    timing phase, so the copies it takes stay out of the first run's
    numbers."""
    import repro_torch
    from repro_torch.render import raster
    from repro_torch.render.png import read_png

    n, e = NODES, len(edges)
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
    for k in MAIN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
    return launches, wall


# ------------------------------------------------------------- phase 5
def full_path(torch, np, cap: Capture, edges, delta, main_wall: float):
    """The paper's comparison arm: ``full_layout_colored`` (grid repulsion,
    500 iterations) + ``render_arrays`` over every edge, on the main path's
    graph. Counters are set to 0 just before and read just after; K5, K6
    and K7 must each launch once per iteration run. Then one iteration from
    the final layout, through ``repro_torch.layout``, records K5–K7's
    inputs at the converged layout for the timing phase."""
    import repro_torch
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.obs.trace import Tracer
    from repro_torch.render import raster

    n, e = NODES, len(edges)
    tr = Tracer()
    cfg = dataclasses.replace(
        repro_torch.default_config(n, e, delta, grid_size=GRID, grid_window=WINDOW,
                                   grid_rebuild=1),
        obs=tr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cap.reset()
    t0 = time.perf_counter()
    pos, groups = repro_torch.full_layout_colored(edges, n, cfg, iterations=FULL_ITERATIONS,
                                                  device="cuda")
    t1 = time.perf_counter()
    layout_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    image, rstats = repro_torch.render_arrays(pos, np.full(n, 2.0), groups, edges,
                                              device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = cap.counts()
    peak = torch.cuda.max_memory_allocated()
    its = int(REGISTRY.gauge("layout.full_iterations_run").value)
    span = {s.name: s.duration for s in tr.spans()}
    wall = t2 - t0
    log("full path stage seconds " + json.dumps({
        "detect_s": span["layout.full.detect"],
        "supergraph_s": span["layout.full.supergraph"],
        "layout_s": span["layout.full"], "layout_iterations": its,
        "layout_ms_per_iteration": span["layout.full"] / max(its, 1) * 1e3,
        "full_layout_colored_s": t1 - t0, "render_s": t2 - t1,
        "node_raster_s": rstats.node_raster_s, "edge_raster_s": rstats.edge_raster_s,
        "compose_s": rstats.compose_s, "full_path_wall_s": wall,
    }))
    log(f"full path max_memory_allocated bytes {max(layout_peak, peak)}: "
        f"{layout_peak} in full_layout_colored, {peak} in render_arrays")
    log("full path launches " + json.dumps(launches))
    log(f"main-path wall / full-path wall on this card: {main_wall / wall} "
        f"({main_wall} s / {wall} s)")
    check(its == FULL_ITERATIONS, f"full layout ran {its} iterations")
    for k in FULL_KERNELS:
        check(launches[k] == its, f"kernel {k} launched {launches[k]} times in {its} iterations")
    check(launches["count_scatter"] > 0, "kernel count_scatter was not launched on the full path")
    check(pos.shape == (n, 2) and groups.shape == (n,), "full path output shapes")
    check(np.isfinite(pos).all(), "non-finite full-graph positions")
    frac, counts = raster.image_summary(image)
    log(f"full image non-background fraction {frac}, palette colors {(counts > 0).sum()}, "
        f"edges streamed {rstats.edges_streamed}")
    check(frac >= 0.01, f"full image is {frac:.4f} non-background (< 1%)")
    check((counts > 0).sum() >= 3, "full image shows fewer than 3 palette colors")

    t0 = time.perf_counter()
    pos0 = fa2.init_positions(n, torch.Generator().manual_seed(cfg.layout.seed)).numpy()
    q = {name: layout_quality(np, p, edges, n) for name, p in (("initial", pos0), ("final", pos))}
    log(f"full layout quality {json.dumps(q)} (host seconds {time.perf_counter() - t0:.3f})")
    # FA2 moves a node at most 10 units per iteration, so 500 iterations
    # from the ±1,000 random start reach an extent of about 6,000: at this
    # size the layout is still expanding and the communities have not
    # separated (PERF.md, PR 12). The same entry point at 6,000 nodes, where
    # 500 iterations do separate them, must show it.
    m = 6000
    small, _ = planted_partition(m, 12, 17.5 * 12 / m, 1.8 / m, seed=SEED)
    scfg = repro_torch.default_config(m, len(small), mode_degree(small, m), grid_size=GRID,
                                      grid_window=WINDOW, grid_rebuild=1)
    spos, _ = repro_torch.full_layout_colored(small, m, scfg, iterations=FULL_ITERATIONS,
                                              device="cuda")
    s0 = fa2.init_positions(m, torch.Generator().manual_seed(scfg.layout.seed)).numpy()
    sq = {name: layout_quality(np, p, small, m) for name, p in (("initial", s0), ("final", spos))}
    log(f"6,000-node full layout quality {json.dumps(sq)}")
    check(sq["final"]["neighborhood"] > 2 * sq["initial"]["neighborhood"]
          and sq["final"]["stress"] < sq["initial"]["stress"],
          "6,000-node full layout: neighbourhoods or stress no better than its start")

    record_grid_inputs(torch, cap, edges, pos)
    return launches


def record_grid_inputs(torch, cap: Capture, edges, pos):
    """One grid iteration from the full path's final layout ``pos``,
    through ``repro_torch.layout``, recording K5–K7's inputs in ``cap``
    (outside any measured run)."""
    import repro_torch
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.graph.utils import degrees, pad_edges

    n, e = NODES, len(edges)
    edges_t = torch.as_tensor(pad_edges(edges, e, n), device="cuda")
    mass = degrees(edges_t, n).to(torch.float32) + 1.0
    lcfg = fa2.FA2Config(iterations=1, repulsion="grid", grid_size=GRID,
                         grid_window=WINDOW, use_radii=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with cap.recording():
        repro_torch.layout(edges_t, torch.ones(e, device="cuda"), mass, n, lcfg,
                           pos0=torch.as_tensor(pos, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    log(f"one grid layout iteration at full width: peak {torch.cuda.max_memory_allocated() - base} "
        f"bytes above its {base} bytes of inputs (recorded copies included)")


def layout_quality(np, pos, edges, n):
    """The port's quality metrics of one layout, with its extent and the
    mean edge length over the mean distance of random node pairs."""
    from repro_torch.quality import neighborhood_preservation, sampled_stress

    pos = np.asarray(pos, np.float64)
    pairs = np.random.default_rng(SEED).integers(0, n, (100_000, 2))
    edge_len = np.linalg.norm(pos[edges[:, 0]] - pos[edges[:, 1]], axis=1).mean()
    pair_len = np.linalg.norm(pos[pairs[:, 0]] - pos[pairs[:, 1]], axis=1).mean()
    return {"neighborhood": neighborhood_preservation(pos, edges, n),
            "stress": sampled_stress(pos, edges, n), "extent": float(np.abs(pos).max()),
            "edge_over_pair_length": float(edge_len / pair_len)}


# ------------------------------------------------------------- phase 6
def time_kernels(torch, np, cap: Capture, main_launches, full_launches):
    """One row per kernel. ``launches`` is the count from the run of the
    path the kernel is on: the main path for K1–K4, the full path for
    K5–K7; K8 is on no path (its launches are 0). ``library_ms`` is the time
    of one PyTorch call computing the same function, or null where there is
    none; ``library`` names the call, or says there is none."""
    from repro_torch.kernels.merge.ref import scatter_combine_ref
    from repro_torch.kernels.raster.ref import count_scatter_into_ref, disk_accum_ref
    from repro_torch.kernels.repulsion.ref import repulsion_chunked

    rows = []

    def row(name, ms, plain_ms, lib_ms, err, bytes_, ops, shape, library=NO_LIBRARY):
        bound_b = bytes_ / PEAK_BYTES_PER_S * 1e3
        bound_o = ops / PEAK_F32_PER_S * 1e3
        path = ("main" if name in MAIN_KERNELS
                else "full" if name in FULL_KERNELS else "none")
        launches = {"main": main_launches, "full": full_launches}.get(path, {})
        r = {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches.get(name, 0), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "library_ms": lib_ms, "library": library, "path": path,
        }
        rows.append(r)
        log(f"{name} {shape}: ms {ms} plain_ms {plain_ms} library_ms {lib_ms} "
            f"({library}) bound_ms {r['bound_ms']} ({r['bound_by']}: bytes {bound_b} ms, "
            f"operations {bound_o} ms) max_abs_err {err} launches {r['launches']} ({path})")

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
        nrow * 16 + capn * 12, nrow, f"N={nrow} kept={idx.numel()} cap={capn}",
        "scatter_reduce_ ×2 + index_put_ on the kept rows")

    # K2, held per row against Σ_j |f_ij|.
    _, (p, m, kr), kw = cap.calls["repulsion_nbody"]
    radii = kw.get("radii")
    k2 = cap.fn("repulsion_nbody")
    fk = k2(p, m, kr, radii=radii)
    fr = repulsion_chunked(p, m, kr, radii=radii)
    check(torch.equal(fk, k2(p, m, kr, radii=radii)), "K2 main-path input: two launches differ")
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
        f"inc={inc3 is not None}", "index_put_ (accumulate) on the kept rows")

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
    time_grid_kernels(torch, np, cap, row)
    return rows


def time_grid_kernels(torch, np, cap: Capture, row):
    """K5–K7 on the full path's recorded inputs (the converged layout), K8
    on the main path's one CMS update."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.cms.ref import cms_update_ref
    from repro_torch.kernels.grid.ref import far_field_ref, near_field_ref
    from repro_torch.kernels.segment.ref import segment_sum_ref

    # K5, held per row against Σ_j |f_ij|.
    _, (pos, mass, cell, ccent, cmass, kr), _ = cap.calls["far_field"]
    k5 = cap.fn("far_field")
    f5 = k5(pos, mass, cell, ccent, cmass, kr)
    check(torch.equal(f5, k5(pos, mass, cell, ccent, cmass, kr)),
          "K5 full-path input: two launches differ")
    ratio, err, fmax, fmed = k2_compare(
        torch, f5,
        far_field_ref(pos, mass, cell, ccent, cmass, kr),
        k5_row_scale(torch, pos, mass, cell, ccent, cmass, kr))
    log(f"K5 full-path worst |Δf|/Σ|f_ij| {ratio}, max|Δf| {err}, max|f| {fmax}, "
        f"median|f| {fmed}")
    check(ratio <= K5_TOL, f"K5 full-path error {ratio} > {K5_TOL} of Σ|f_ij|")
    n, c = pos.shape[0], ccent.shape[0]
    occupied = int((cmass > 0).sum())
    row("far_field",
        cuda_ms(torch, lambda: k5(pos, mass, cell, ccent, cmass, kr), REPS),
        cuda_ms(torch, lambda: far_field_ref(pos, mass, cell, ccent, cmass, kr), 3),
        None, err, n * 16 + c * 12 + n * 8, K5_OPS_PER_PAIR * n * c,
        f"n={n} C={c} occupied={occupied}")

    # K6, bitwise. Operations: one compare per in-range band slot and the
    # pair arithmetic per same-cell pair this input holds.
    _, (pos_s, mass_s, cell_s, kr, w), _ = cap.calls["near_field"]
    k6 = cap.fn("near_field")
    check(torch.equal(k6(pos_s, mass_s, cell_s, kr, w),
                      near_field_ref(pos_s, mass_s, cell_s, kr, w)),
          "K6 differs on full-path input")
    n = pos_s.shape[0]
    w_eff = min(w, n - 1)
    slots = sum(2 * (n - k) for k in range(1, w_eff + 1))
    pairs = sum(2 * int((cell_s[k:] == cell_s[:-k]).sum()) for k in range(1, w_eff + 1))
    row("near_field",
        cuda_ms(torch, lambda: k6(pos_s, mass_s, cell_s, kr, w), REPS),
        cuda_ms(torch, lambda: near_field_ref(pos_s, mass_s, cell_s, kr, w), 3),
        None, 0.0, n * 24, slots + K6_OPS_PER_PAIR * pairs,
        f"n={n} W={w} band_slots={slots} same_cell_pairs={pairs}")

    # K7: bitwise against its plain version on the CPU and run to run,
    # within its bound of the card's plain version. The library yardstick
    # is index_add_ on the kept rows (filtered outside the timed span).
    _, (data, seg, n_seg), kw = cap.calls["segment_sum"]
    k7 = cap.fn("segment_sum")
    worst = k7_check(torch, "full-path", data, seg, n_seg, kw.get("indices_are_sorted", False))
    keep = (seg >= 0) & (seg < n_seg)
    idx7, data7 = seg[keep].long(), data[keep]
    out7 = torch.zeros((n_seg,) + tuple(data.shape[1:]), device=data.device)
    largest = int(torch.bincount(idx7, minlength=n_seg).max())
    log(f"K7 full-path worst |Δ| / 2γ(k−1)Σ|x| {worst}; largest segment {largest} rows")
    e, d = data.shape[0], data.shape[1]
    row("segment_sum",
        cuda_ms(torch, lambda: k7(data, seg, n_seg, **kw), REPS),
        cuda_ms(torch, lambda: segment_sum_ref(data, seg, n_seg), REPS),
        cuda_ms(torch, lambda: out7.index_add_(0, idx7, data7), REPS),
        0.0, e * (4 * d + 4) + n_seg * d * 4, e * d,
        f"E={e} D={d} N={n_seg} largest_segment={largest}",
        "index_add_ on the kept rows")

    # K8 on the main path's CMS input: the keys hashed once, outside the
    # timed span; the library yardstick is index_put_ (accumulate) on the
    # kept slots. End to end, the pipeline's core.cms.update (hash +
    # index_put_) against kernels.cms.ops.update (hash + K8) decides
    # whether K8 is wired into the pipeline.
    _, (sketch, keys, weights, cfg), _ = cap.calls["cms_update"]
    h = cms_ops.hashed_buckets(keys, cfg)
    wv = weights.to(torch.float32).contiguous()
    got = cms_ops.update_hashed(sketch, h, wv)
    check(torch.equal(got, cms_update_ref(sketch, h, wv)), "K8 differs on main-path input")
    check(torch.equal(cms_ops.update(sketch, keys, weights, cfg),
                      cms_lib.update(sketch, keys, weights, cfg)),
          "K8 ops.update differs from core.cms.update on main-path input")
    rows8, n8 = h.shape
    kept = h >= 0
    r8 = torch.arange(rows8, device=h.device)[:, None].expand_as(h)[kept]
    b8, w8 = h[kept].long(), wv[None, :].expand_as(h)[kept]
    lib8 = sketch.clone()
    row("cms_update",
        cuda_ms(torch, lambda: cms_ops.update_hashed(sketch, h, wv), REPS),
        cuda_ms(torch, lambda: cms_update_ref(sketch, h, wv), REPS),
        cuda_ms(torch, lambda: lib8.index_put_((r8, b8), w8, accumulate=True), REPS),
        0.0, rows8 * n8 * 4 + n8 * 4 + 2 * sketch.numel() * 4, int(kept.sum()),
        f"rows={rows8} cols={sketch.shape[1]} n={n8} kept={int(kept.sum())}",
        "index_put_ (accumulate) on the kept slots")
    pipe_ms = cuda_ms(torch, lambda: cms_lib.update(sketch, keys, weights, cfg), REPS)
    k8_ms = cuda_ms(torch, lambda: cms_ops.update(sketch, keys, weights, cfg), REPS)
    log(f"CMS update end to end on the main-path input: core.cms.update "
        f"(hash + index_put_) {pipe_ms} ms, kernels.cms.ops.update (hash + K8) {k8_ms} ms")


# ------------------------------------------------------------- phase 7
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
    grid_consistency(torch, np)


def grid_consistency(torch, np):
    """``full_layout_colored`` (grid repulsion above 4,096 nodes) at 8,000
    nodes on the card and on the CPU, 4 iterations from the degree init."""
    import repro_torch
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.core.scoda import detect_communities
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree, pad_edges
    from repro_torch.kernels.grid.ref import bin_and_sort

    n = 8000
    edges, _ = planted_partition(n, 40, 0.02, 0.0004, seed=1)
    cfg = repro_torch.default_config(n, len(edges), mode_degree(edges, n), init="degree")
    out = {d: repro_torch.full_layout_colored(edges, n, cfg, iterations=4, device=d)
           for d in ("cuda", "cpu")}
    padded = pad_edges(edges, len(edges), n)
    labels = {d: detect_communities(torch.as_tensor(padded, device=d), n, cfg.scoda)[0].cpu()
              for d in ("cuda", "cpu")}
    check(torch.equal(labels["cuda"], labels["cpu"]), "grid path: labels differ cuda/cpu")
    check(np.array_equal(out["cuda"][1], out["cpu"][1]), "grid path: groups differ cuda/cpu")
    # The first iteration's cells: both devices bin the same positions.
    mass = torch.as_tensor(np.bincount(edges.reshape(-1), minlength=n)[:n] + 1.0,
                           dtype=torch.float32)
    pos0 = fa2.init_positions_degree(n, mass)
    cells = {d: bin_and_sort(pos0.to(d), 64) for d in ("cuda", "cpu")}
    check(all(torch.equal(a.cpu(), b) for a, b in zip(cells["cuda"], cells["cpu"])),
          "grid path: first-iteration cell ids or order differ cuda/cpu")
    # Each device's own degree init (sines and cosines round differently).
    own0 = fa2.init_positions_degree(n, mass.cuda()).cpu()
    init_moved = int((bin_and_sort(own0, 64)[0] != cells["cpu"][0]).sum())
    # Nodes whose cell differs at the end, binned on the CPU from each result.
    final = {d: bin_and_sort(torch.as_tensor(out[d][0]), 64)[0] for d in out}
    moved = int((final["cuda"] != final["cpu"]).sum())
    scale = float(np.abs(out["cpu"][0]).max())
    perr = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    log(f"grid consistency n={n}: labels, groups, first-iteration cells bitwise; "
        f"degree-init cells differing between the devices' own inits {init_moved}; "
        f"final cells differing {moved}; positions max|Δ| {perr} of {scale}")
    check(perr <= 1e-4 * scale, f"grid path positions differ cuda/cpu by {perr} "
          f"(> 1e-4·{scale}; {moved} nodes end in another cell)")


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
            spills = [ln for ln in ptx if re.search(r"[1-9]\d* bytes spill", ln)]
            check(not spills, f"{name} spills registers: {spills}")
    with phase("kernels"):
        kernel_checks(torch, np)
    cap = Capture(torch)
    edges, delta = make_graph()
    with phase("main path"):
        main_launches, main_wall = main_path(torch, np, cap, edges, delta)
    with phase("full path"):
        full_launches = full_path(torch, np, cap, edges, delta, main_wall)
    del edges
    with phase("timing"):
        rows = time_kernels(torch, np, cap, main_launches, full_launches)
    check(len(rows) == len(KERNELS), f"{len(rows)} kernel rows, expected {len(KERNELS)}")
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
