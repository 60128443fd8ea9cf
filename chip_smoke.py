#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. card      — ``nvidia-smi`` name and power limit.
2. build     — compiles the eight kernel libraries from ``src/repro_torch/csrc``
               (one ``nvcc`` per source, all at once), prints each one's
               registers and fails if one spills.
3. kernels   — each kernel against its plain PyTorch version on the card,
               on adversarial inputs and on synthetic inputs at the paths'
               shapes: K1, K3, K4, K6, K8 bitwise (K1, K3, K4, K6 and K8
               also run to run), K2 and K5 within their tolerances and
               bitwise run to run (K2 also near contact, where
               eff = d − ri − rj cancels), K2's and K6's row entries
               bitwise the same rows of their full launches (halves,
               quarters, ragged ranges, one row), K7 bitwise against its plain
               version on the CPU, within its bound of the one on the card,
               and bitwise run to run; K7's layout entries (the layout build,
               the per-edge sum through a layout at D = 1 to 128, the gather
               backward, the fused attraction) bitwise their plain versions
               on the CPU, the pre-change compositions on the card and run
               to run (``layout_checks``). K1's cases hold merges at capacity,
               with all-duplicate, all-new and all-sentinel chunks, −0.0
               weights and ragged capacities; K3's raw entry a hot pixel,
               runs, dropped rows, ragged and misaligned rows; K3's
               small-disk entry NaN and far centres, r = 0 and 8, integer
               and half-pixel centres, image edges, bad groups, no disk and
               a 1023×769 image; K4's 40 groups, r = +inf, NaN and far
               centres, pixels exactly on the circle, 2,000 coincident
               disks and the accumulating form; K8's both entries (buckets
               given, keys hashed in the kernel) one bucket above 2²⁴ (run
               to run and within 2γ(k)·Σ|x|), 34,000 columns, all keys in
               one bucket, all padding, n = 0 and 1, and fractional
               weights (within rounding; float atomics, so not run to run).
4. main path — ``biggraphvis`` + ``BGVResult.render`` on a planted-partition
               graph at web-BerkStan's size (685,230 nodes, ≈ 6.6 M edges),
               with every launch counter set to 0 just before and read just
               after; wall time, stage times and peak memory are taken from
               this run, and the content of the image is checked; K7's fused
               attraction launches once an iteration and its layout build
               once. A second run of the same path records each kernel's
               inputs. Then the seeded draws (``prng_checks``): the
               layouts' uniform and the weights' normal on the card against
               the CPU and the reference's recorded bits, a normal draw in
               chunks against the whole draw, ``split``, and the timed
               draws (yi-6b's embedding leaf among them).
5. full path — ``full_layout_colored`` (grid repulsion, 500 iterations) +
               ``render_arrays`` over every edge, on the same graph, with the
               counters set to 0 just before and read just after: stage
               times, wall, peak memory (``render_arrays`` below 1 GiB), the
               image and the layout's quality against its initial
               positions; K5, K6, K7's cell statistics and its fused
               attraction launch once an iteration, the layout build once.
               One more iteration from the final layout records K5–K7's
               inputs, and one node pass and one edge chunk from it K3's,
               under keys of their own.
5b. bfloat16 — half-width layouts (``half_layout_phase``): K2 (whole and
               its row entry on rank 1's half) and K7's fused attraction
               in bfloat16 on the two paths' recorded inputs and in
               float16 on seeded inputs of the main path's shapes, each
               against its plain version (K2 within K2_TOL·Σ|f_ij| + one
               ulp of the type, the attraction bitwise the CPU's), in the
               layout's type and bitwise run to run; ``layout_supergraph``
               of phase 4's supergraph in bfloat16 (100 iterations: K2 and
               the attraction launched 100 times each, handed the same
               bfloat16 pos, no float32 copy of it made; finite, bitwise
               run to run) and ``BGVResult.render`` of it; the full path's
               grid layout in bfloat16 (500 iterations, K5–K7 once an
               iteration, finite, bitwise run to run); a 3-iteration
               bfloat16 layout at the CPU tests' size against the CPU
               within 2⁻⁷·max|pos|.
6. serve     — the tile service over phase 4's result (685,230 nodes,
               ≈ 12.8 k supernodes): ``TilePyramid`` (256-px tiles, 3
               levels, 21 tiles) and ``TileEngine`` (64 MiB, 8 slots) warm
               every tile and the 8 largest drillable communities, then
               serve ``synthetic_trace(pyramid, 400, seed=0)`` on the warmed
               engine (all hits) and on a cold one (misses rendered on the
               card), counters set to 0 just before each and read just
               after: warm-up seconds, tiles/s, hit rate, p50/p99 miss
               latency, launches, peak memory. Checks: pyramid tiles bitwise
               against direct ``render_arrays`` on the card, one within ±1
               of the CPU's; one drill's groups bitwise, its positions
               within 1e-4·max|pos| of the CPU's after 4 iterations and its
               layout quality within 1 % after its 60 (not its image: K2
               rounds differently from its plain version, and FA2
               amplifies that over 60 iterations), its 60 iterations
               bitwise run to run on the card; no kernel build during a
               trace; no failed tile; the cold trace launches K3's two
               entries and, through the drills, K1, K8, K2 and K7.
7. launchers — ``repro_torch.launch.serve``, ``render_runner`` and ``layout``
               at a small size, at once, each a subprocess on the card by
               default with ``--trace-out`` and ``--metrics-out`` (serve
               also ``--profile``): each must exit 0 and write its image,
               trace and metrics with the card's memory gauges; the
               profile's device busy share is printed. Beside them
               ``stream_runner`` streams an ``.npy`` store with a checkpoint
               every 4 chunks and gets SIGTERM once its first checkpoint
               is on disk: it must exit 0 preempted; run again with
               ``--resume``, it must report the cursor it resumed at and
               stream equal to one shot.
8. multi-device — the multi-device paths, ranks of one process each
               sharing the card under gloo (``multi_device_phase``): the
               main path on 2 ranks with ``shard_detect`` and
               ``shard_layout`` (every integer output bitwise phase 4's,
               positions within 1e-4·max|pos|, K1, K2's row entry and K8
               launched on both ranks, K3 and K4 on rank 0 for the render);
               the full graph's grid force pass on 2 ranks (20 iterations;
               K5, K6's row entry and K7 on both ranks); ``stream_runner
               --shard all`` on 4 ranks under ``torch.distributed.run``; a
               4-rank checkpoint resumed on one rank, bitwise; the
               supergraph laid out in bfloat16 on the 2 ranks (K2's row
               entry and the attraction 100 times a rank, within
               2⁻⁷·max|pos| of phase 5b's one-rank layout).
9. timing    — each kernel entry on the inputs its path gave it (recorded
               in phases 4 and 5; K3 on both paths): held against its plain
               version again, and timed with CUDA events beside the plain
               version, one PyTorch library call where there is one, and its
               bound. K1's generic scatter and K8's hashed entry (on no
               path) are timed on the main path's K1 rows and CMS input;
               K2's entries and K7's attraction also in bfloat16, on the
               casts of the same inputs (rows ``*_bf16``).
10. consistency — the full path's node accumulator (685,230 small disks)
               from K3's disk entry against the plain version on the card;
               a 3,000-node graph through ``biggraphvis`` and an 8,000-node
               graph through ``full_layout_colored`` on the card and on the
               CPU: labels, groups, supergraph, cell ids and raster
               accumulators bitwise, positions within tolerance; the
               3,000-node graph from a ``.npy`` file through the pinned
               staging ring, bitwise.
11. resilience — on phase 4's graph and config, streamed from an ``.npy``
               store through the pinned staging ring: a run checkpointed
               at round boundaries is killed in detect (round 2, chunk 50
               of 101) and resumed through ``biggraphvis(..., resume=True)``
               + ``render`` with the counters set to 0 just before and read
               just after (labels, graph degrees, sizes and supergraph
               bitwise against phase 4, Q within 1e-6, positions bitwise,
               the image written, K1, K2, K3, K4, K7 and K8
               launched); a ``stream_pipeline`` run is killed after a save
               inside the supergraph pass and resumed (bitwise against an
               uninterrupted one, Q too); a validated run through
               ``ChaosEdgeStore`` faults (transient I/O errors and a
               truncated read, a permanently failing chunk, a bit-flip)
               must account for every injected fault and equal, bitwise, a
               trusting run on the equivalent in-memory array. It prints
               saves, bytes per checkpoint, seconds per save (to the host,
               and the npz write) and the resumed run's wall time beside
               phase 4's, each with the card's name and power limit.
12. dry-run cells — the BigGraphVis cells of
               ``repro_torch.configs.biggraphvis`` at the reference's padded
               shapes through ``launch.steps.build_bgv_step``
               (``dry_run_phase``): detect on this graph and on a
               soc-LiveJournal-sized one made on the card, the exact and
               grid layout steps at the paper's supernode counts; each
               bitwise run to run, against the CPU or a direct ``fa2.step``,
               with its step time; each layout step builds one segment
               layout and sums its two-scatter attraction through it once,
               and that sum (``layout_livejournal``'s input) is timed for
               the ``kernels`` line.
13. models   — yi-6b at full width, 28 of 32 layers, through ``LMEngine`` (16
               requests on 8 slots × 2,048 positions, teacher-forced against
               a prefill, each request's tokens equal to its solo run's),
               granite-moe-1b-a400m, both LMs at 2 layers against the CPU,
               SASRec's serve and retrieval cells, gin-tu and gat-cora
               (``models_phase``): tokens/s, ms per decode step, peak memory.
               The LMs' weights are the smoke's own seeded draw at the true
               fan-in (``lm_params``); SASRec's and the GNNs' the
               reference's (``init_params`` from ``prng.key(SEED)``),
               SASRec's rescaled to the true fan-in.
14. training — ``repro_torch.train`` through ``make_train_step`` at full
               width (``training_phase``): yi-6b ``train_4k`` with its depth
               cut by a memory estimate (17 of 32 layers, one 4,096-token
               row), granite-moe-1b-a400m at full depth with the float32 and
               the 8-bit AdamW state, SASRec ``train_batch`` uncut, gin-tu
               on ogbn-products' counts (remat), twice, bitwise; 3 steps
               each (step ms, tokens/s, estimate and peak memory; the loss
               finite and the last below the first + 0.5). Card against CPU
               after 2 steps (yi-6b and granite at 2 layers, gin-tu
               ``molecule``, gat-cora ``full_graph_sm``, SASRec at batch
               256), the GNNs bitwise run to run; K7's layout build, per-edge
               sum and gather backward launched by every GNN step (2, 20 and
               10 a gin-tu step on ogbn-products: no sum sorts) and timed on
               ogbn-products' edges against the pre-change composition;
               ``python -m repro_torch.launch.train``
               killed after step 12 and resumed, bitwise an uninterrupted
               run.
15. dry run  — the dry run (``repro_torch.launch.dryrun``,
               ``dry_run_smoke_phase``): (a) each kernel entry with an
               abstract rule (K2's, K5's, K6's, K7's and K8's) launched once
               and called once on fake CUDA tensors of the same inputs, the
               outputs' shapes, dtypes and strides equal, and the grid form
               of ``layout_livejournal`` run and traced so, its rule calls
               equal to its launches and K5's and K6's counts their bound
               arithmetic; (b) each one-card run of
               the training phase (yi-6b, granite-moe with both states,
               SASRec, gin-tu) predicted by one dry step of the same
               configuration and batch on fake CUDA tensors — the bytes on
               the card before the run, less its parameters and batch, plus
               the dry step's peak — within 20 % of
               ``max_memory_allocated``; (c) the CLI on two cells
               (``layout_livejournal`` single, gin-tu ``full_graph_sm``
               multi) on fake CUDA and on fake CPU tensors, the records
               equal but for ``trace_s``.
16. model mesh — ``build_step(..., mesh)`` on 2 ranks sharing the card
               under gloo (``model_mesh_phase``): yi-6b ``train_4k`` at
               full width, tensor and sequence parallel on (1, 2), at the
               depth its estimate allows under 60 GB, at most 4 layers;
               granite-moe, expert and tensor parallel, 2 layers; yi-6b at
               2 layers, data parallel with ZeRO-3 of d_model and
               ``compress_grads`` on (2, 1); yi-6b at 2 layers with the
               sequence split and again unsplit on (1, 2) (bitwise
               logged); yi-6b at 2 layers on (2, 1) with 2 microbatches of
               4 × 4,096 tokens and a ragged loss mask (fault F3), one
               step; SASRec ``train_batch`` uncut with its item table
               split; gin-tu ``full_graph_sm``, twice, bitwise, and
               graphcast's at 2 layers, one step, each with its edges and
               its node rows split; the four ``bgv_*`` cells at their
               padded shapes and a grid variant (K8, K2's and K6's row
               entries, K5, K7). Each against its one-rank step on the
               card: the LMs and SASRec within ``TRAIN_TOL``, gin-tu within
               ``MESH_GNN_TOL``, graphcast within ``MESH_GRAPHCAST_TOL``,
               the BigGraphVis cells bitwise; per rank: launches, step ms,
               peak bytes, collective seconds, and the GNNs' node rows.
17. serving mesh — the serving cells on 2 ranks sharing the card under
               gloo (``serving_mesh_phase``), bfloat16 weights at the true
               fan-in, each against its one-rank step run first on the
               card: yi-6b ``decode_32k`` at full width and depth (8 rows ×
               32,768 positions, 16 steps, slots on both halves of the
               cache, one crossing the ranks' boundary, one inactive) and
               gemma3-4b ``long_500k`` (6 layers, 1 row × 524,288
               positions, 4 steps) on (1, 2), the KV cache split by
               position (split-K attention); yi-6b ``prefill_32k`` (2
               layers, 32,768 tokens) with the sequence split and again
               unsplit (each rank's peak bytes both ways); SASRec
               ``serve_p99`` on (1, 2) and (2, 1), ``retrieval_cand`` on
               (1, 2), uncut. Gates: logits within ``SERVE_TOL``,
               the cache bitwise where no step wrote and on layer 0's new
               entries, two runs bitwise, SASRec within
               ``TF_TOL["float32"]``; per rank: step ms, collective seconds
               and calls, peak bytes beside the one-rank step's.

Every layout on the card (main path, full path, drills, resumed and
sharded runs) is held bitwise run to run: FA2's attraction sums in a fixed
order through kernel K7's fused ``attraction_sum`` entry.

It then prints the ``kernels`` JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. It exits non-zero, printing no
result line, when CUDA is unavailable, when the port's sources are not
beside it, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
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
MAIN_CHUNK = 1 << 16  # edges a chunk on the main path (101 chunks a pass)
# The full path: the reference's and the paper's full-graph iteration count,
# and the grid of default_config.
FULL_ITERATIONS, GRID, WINDOW = 500, 64, 32
REPS = 20  # back-to-back launches per CUDA-event timing
# Peak device memory: the main path's before K8 and K3's disk entry joined
# it (PERF.md §5), and a ceiling for the full path's render_arrays, which
# materialised 5,453,221,888 bytes of small-disk boxes before the disk entry.
MAIN_PEAK_BYTES = 255_188_992
FULL_RENDER_PEAK_BYTES = 1 << 30
QUEUE_CYCLES = 100_000_000  # ≈ 50 ms of device sleep ahead of each timing
# The tile service over the main path's result: the reference launcher's
# defaults (256-px tiles, 3 levels, 64 MiB of cache, 8 render slots, a drill
# pool of 8, 400 requests).
SERVE_TILE, SERVE_DEPTH, SERVE_CACHE, SERVE_SLOTS = 256, 3, 64 << 20, 8
SERVE_DRILLS, SERVE_REQUESTS = 8, 400
LAUNCHER_TIMEOUT = 300  # seconds, for the three small launcher runs together
# stream_runner: ≈ 159 k edges in 156 chunks a pass, so a checkpoint every
# chunk leaves hundreds of boundaries between the first save and the end.
STREAM_RUNNER_ARGS = ["--nodes", "20000", "--communities", "200", "--chunk", "1024",
                      "--block-size", "1024", "--iterations", "20"]
# Positions of the card's layouts are held bitwise run to run, and a resumed
# or sharded run bitwise against its single-rank, uninterrupted run: FA2's
# attraction sums in a fixed order (kernel K7), as K2, K5 and K6 do.
# The multi-device phase: ranks of one process each, sharing the card under
# gloo (NCCL refuses two ranks on one card). The grid force pass runs the
# full graph for 20 iterations, cut from the full path's 500 for time; the
# D = 4 runs take the stream launcher's size. A spawned group that is not
# done after MD_TIMEOUT seconds is killed and fails the phase.
MD_RANKS, MD_GRID_ITERATIONS, MD_RUNNER_RANKS, MD_TIMEOUT = 2, 20, 4, 600
MD_SAVE_EVERY = 8  # chunks between the 4-rank run's checkpoints
MD_RUNNER_ARGS = ["--shard", "all", "--backend", "gloo"]
# The dry-run cells: soc-LiveJournal's counts (src/repro/configs/
# biggraphvis.py:46-49), made on the card in blocks of LJ_BLOCK nodes.
LJ_NODES, LJ_EDGES, LJ_BLOCK, LJ_P_IN = 3_997_962, 34_681_189, 20, 0.9
# The layout cells' supergraphs: the paper's supernode and superedge counts
# (Table 1), under the reference's padded shapes.
LAYOUT_REAL = {"layout_berkstan": (31_213, 57_382), "layout_livejournal": (248_188, 566_160)}
# The models phase. LMEngine's slots and positions; the teacher-forced
# gate's tolerance on |decode − prefill| logits by activation type. Decode
# runs its products with M = slots, prefill with M = tokens: cuBLAS picks
# other algorithms, which round differently. Measured on an H100 80GB HBM3
# at 700 W (PERF.md §6, PR 21): bfloat16 0.1016 (yi-6b, 32 layers), float32
# 1.57e-5 (yi-6b at 2 layers) and 6.9e-6 (granite, 24 layers); the
# tolerances are about 3× and 6× those.
ENGINE_SLOTS, ENGINE_LEN = 8, 2048
# yi-6b's depth in LMEngine: its concurrent and solo decodes are host-bound,
# about proportional to depth, and were 148.5 s of the models phase at 32
# layers on a slow host; 28 of 32 pays for the bfloat16 layout checks
# (≈ 10.3 s; PERF.md §6, PR 30).
ENGINE_LAYERS = 28
TF_TOL = {"float32": 1e-4, "bfloat16": 0.3}
# Card against CPU, float32 (TF32 off), per max|out|: the two sides'
# products and reductions add in different orders. Measured: LM logits
# 2.2e-6, SASRec scores 1.4e-6, GNN outputs 3.9e-7.
LM_CPU_TOL, SAS_TOL, GNN_TOL = 2e-5, 1e-5, 1e-5

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate
# outside the tensor cores (a fused multiply-add counts as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# The bounds of K2's, K5's, K6's, K7's and K8's rows come from the cost
# functions beside their wrappers (``repulsion_cost``, ``far_field_cost``,
# ``near_field_cost`` with the input's same-cell pairs, ...),
# which the dry run's abstract rules use too; ``bytes_ops`` puts one in
# ``kernel_row``'s order.
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
# Per node and axis: |f_kernel − f_plain| ≤ K5_TOL · Σ_j |f_ij|. The
# kernel fuses d² into an FMA (≤ 1 ulp), takes an approximate reciprocal
# (≤ 2⁻²³) and applies kr·m_i once per node, so each pair force differs by
# a few ulp; it adds 256-cell tile sums, erring by at most about
# (12 + 256 + C/256) · 2⁻²⁴ of Σ|f_ij| (1.7e-5 at C = 4,096), and the plain
# version's tree sum over the C cells less.
K5_TOL = 1e-4
# The layouts of src/repro_torch/csrc/near_field.cu (sorted nodes a block,
# the window with its own kernel) and segment_sum.cu (floats a warp stages
# at a time), for the edge cases.
K6_BLOCK_NODES, K6_FIXED_WINDOW = 512, 32
K7_CHUNK_FLOATS = 1024
SEG_SPAN = 256  # rows a warp stages at a time in K7's narrow layout entries
K1_TILE = 512  # output slots a merge_place block owns (csrc/merge_scatter.cu)

# The rows of the ``kernels`` line, one per kernel entry and path: name →
# (source, the TPU kernel it replaces, its launch counter in
# ``build.LAUNCHES``, the path whose measured run gives its launches, or
# None for an entry on no path).
_SPLAT = "src/repro/kernels/raster/splat.py"
_CMS = "src/repro/kernels/cms/cms_update.py:64"
_SEG = "src/repro/kernels/segment/seg_matmul.py:60"
KERNELS = {
    "merge_scatter": ("merge_scatter", "src/repro/kernels/merge/sorted_merge.py:96",
                      "merge_scatter", "main"),
    # The generic scatter for arbitrary positions, K1's second entry.
    "scatter_combine": ("merge_scatter", "src/repro/kernels/merge/sorted_merge.py:96",
                        "scatter_combine", None),
    "repulsion_nbody": ("repulsion_nbody", "src/repro/kernels/repulsion/nbody.py:84",
                        "repulsion_nbody", "main"),
    # K2's row range: the owned targets of the multi-device layout.
    "repulsion_rows": ("repulsion_nbody", "src/repro/kernels/repulsion/nbody.py:84",
                       "repulsion_rows", "multi"),
    # K3: the raw entry (edge chunks) and the small-disk entry (node pass).
    "count_scatter": ("count_scatter", f"{_SPLAT}:94", "count_scatter", "main"),
    "count_scatter_full": ("count_scatter", f"{_SPLAT}:94", "count_scatter", "full"),
    "count_disks": ("count_scatter", f"{_SPLAT}:94", "count_disks", "main"),
    "count_disks_full": ("count_scatter", f"{_SPLAT}:94", "count_disks", "full"),
    "disk_accum": ("disk_accum", f"{_SPLAT}:167", "disk_accum", "main"),
    "far_field": ("far_field", "src/repro/kernels/grid/tiled.py:96", "far_field", "full"),
    "near_field": ("near_field", "src/repro/kernels/grid/tiled.py:188", "near_field", "full"),
    # K6's row range: the owned rows of the multi-device grid force pass.
    "near_field_rows": ("near_field", "src/repro/kernels/grid/tiled.py:188",
                        "near_field_rows", "multi"),
    "segment_sum": ("segment_sum", _SEG, "segment_sum", "full"),
    # K7's layout entries. The layout build (segment_offsets): the
    # attraction's source layout once a layout call on the main and full
    # paths, and the GNN's id arrays on the training path (2 a gin-tu step).
    "segment_offsets": ("segment_sum", _SEG, "segment_offsets", "main"),
    "segment_offsets_full": ("segment_sum", _SEG, "segment_offsets", "full"),
    "segment_offsets_train": ("segment_sum", _SEG, "segment_offsets", "train"),
    # FA2's attraction fused (attraction_sum): the main path's supergraph,
    # the full path's 13.2 M directed edges.
    "attraction_sum": ("segment_sum", _SEG, "attraction_sum", "main"),
    "attraction_sum_full": ("segment_sum", _SEG, "attraction_sum", "full"),
    # The per-edge sum through a layout (segment_sum_edges): the
    # two-scatter attraction of a single FA2 step (the dry-run layout
    # cells, narrow rows through a sort order), the GNN's message sums
    # (forward and remat recompute, wide rows), and its row gathers'
    # gradients (segment_sum_gather_bwd), gin-tu on ogbn-products' counts.
    "segment_sum_edges": ("segment_sum", _SEG, "segment_sum_edges", "step"),
    "segment_sum_edges_train": ("segment_sum", _SEG, "segment_sum_edges", "train"),
    "segment_sum_gather_bwd": ("segment_sum", _SEG, "segment_sum_gather_bwd", "train"),
    # K8: keys hashed in the kernel (core.cms.update), and buckets given.
    "cms_update_keys": ("cms_update", _CMS, "cms_update_keys", "main"),
    "cms_update": ("cms_update", _CMS, "cms_update", None),
    # Half-width layouts (FA2Config.dtype "bfloat16"): K2 on the main path's
    # supergraph laid out in bfloat16, its row entry on that layout's 2-rank
    # form, K7's attraction on it and on the full path's grid layout.
    "repulsion_nbody_bf16": ("repulsion_nbody", "src/repro/kernels/repulsion/nbody.py:84",
                             "repulsion_nbody", "bf16"),
    "repulsion_rows_bf16": ("repulsion_nbody", "src/repro/kernels/repulsion/nbody.py:84",
                            "repulsion_rows", "multi_bf16"),
    "attraction_sum_bf16": ("segment_sum", _SEG, "attraction_sum", "bf16"),
    "attraction_sum_full_bf16": ("segment_sum", _SEG, "attraction_sum", "full_bf16"),
}
# Counters the main path must move; on the full path K5, K6 and K7's cell
# statistics and fused attraction launch once per iteration, and K3's raw
# entry once per edge chunk.
MAIN_KERNELS = {c for _, _, c, path in KERNELS.values() if path == "main"}
FULL_KERNELS = ("far_field", "near_field", "segment_sum", "attraction_sum")
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


def bits_equal(torch, a, b) -> bool:
    """Same shape, dtype and bits (−0.0 differs from +0.0; NaN equals the
    same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return torch.equal(a, b)


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


def k_row_ranges(n: int) -> list[tuple[int, int]]:
    """Row ranges ``(i0, nl)`` of n for the row entries' checks: the halves
    and quarters that 2 and 4 ranks own, a ragged range that starts and
    ends inside a block, and the last row."""
    out = [(0, n // 2), (n // 2, n - n // 2), (n // 4, n // 4), (3 * n // 4, n - 3 * n // 4)]
    if n > 700:
        out.append((257, n - 700))
    out.append((n - 1, 1))
    return [(i0, nl) for i0, nl in out if nl > 0]


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
    from repro_torch.kernels.raster.ref import (
        count_scatter_into_ref,
        disk_accum_into_ref,
        disk_accum_ref,
    )
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.repulsion.ref import repulsion_chunked

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    i32max = np.iinfo(np.int32).max

    def same(name, got, want):
        for g, w in zip(got, want):
            check(bits_equal(torch, g, w), f"{name}: kernel differs from plain version")

    # K1: merge of sorted deduped runs (full wrapper path) and raw scatter.
    def run_pair(s_cap, cap, c, ks, kc, dup=0, neg_zero=False):
        """A sorted state run of ``ks`` unique pairs and a sorted chunk run
        of ``kc`` pairs, ``dup`` of them already in the state; with
        ``neg_zero``, every other weight of each run is −0.0."""
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
            if neg_zero:
                out[2][:len(k):2] = -0.0
            return out

        st = run(keys[:ks], cap)
        ch = run(np.concatenate([keys[ks:ks + kc - dup], keys[:dup]]), c)
        return [torch.as_tensor(x, device=dev) for x in st + ch], s_cap

    # (name, s_cap, cap, C, state pairs, chunk pairs, of them duplicates).
    # merge_place owns K1_TILE slots a block; the state at capacity
    # overflows (the union is truncated), as on the main path.
    cases = [("small", 16, 32, 16, 12, 8, 4), ("small_full", 16, 32, 16, 32, 16, 2),
             ("all_padding", 16, 32, 16, 0, 0, 0), ("random", 64, 100, 24, 77, 20, 5),
             ("packing_limit", 1 << 16, 16, 8, 12, 6, 3),
             ("main_shape", 65536, 262144, 65536, 200000, 40000, 15000),
             ("at_capacity", 65536, 262144, 65536, 262144, 65536, 20000),
             ("all_duplicates", 65536, 262144, 65536, 150000, 65536, 65536),
             ("all_new", 65536, 262144, 65536, 150000, 65536, 0),
             ("empty_state", 65536, 262144, 65536, 0, 60000, 0),
             ("all_sentinel_chunk", 65536, 262144, 65536, 150000, 0, 0),
             ("neg_zero", 512, 4000, 1500, 3000, 1500, 700), ("cap_1", 64, 1, 8, 1, 5, 1),
             ("cap_1_new", 64, 1, 8, 0, 5, 0), ("cap_ragged", 512, 1000, 300, 900, 300, 50),
             ("cap_ragged_large", 65536, K1_TILE * 500 - 1, 4096, K1_TILE * 500 - 1, 4096, 99)]
    for name, s_cap, cap, c, ks, kc, dup in cases:
        args, s_cap = run_pair(s_cap, cap, c, ks, kc, dup, neg_zero=name == "neg_zero")
        got = merge_ops.merge_combine(*args, s_cap)
        same(f"K1 merge {name}", got, merge_combine_ref(*args, s_cap))
        same(f"K1 merge {name} run to run", got, merge_ops.merge_combine(*args, s_cap))
        if name == "at_capacity":
            check(int(got[3]) > cap, "K1 at_capacity: the union does not overflow")
        if name == "neg_zero":
            check(bool((got[2] == 0).any()) and not bool(torch.signbit(got[2]).any()),
                  "K1 neg_zero: a −0.0 weight did not come back +0.0")
    n = 5000
    pos = torch.as_tensor(rng.integers(-50, 4000, n).astype(np.int32), device=dev)
    pos[::7] = i32max
    a = torch.as_tensor(rng.integers(0, 99, n).astype(np.int32), device=dev)
    w = torch.as_tensor(rng.integers(1, 4, n).astype(np.float32), device=dev)
    same("K1 raw scatter", merge_ops.scatter_combine(pos, a, a, w, 4000),
         scatter_combine_ref(pos, a, a, w, 4000))
    log(f"K1 merge_scatter: merge_place bitwise and run to run on {len(cases)} merges; "
        "the generic scatter_combine bitwise on a raw scatter")

    # K2: ragged n (one node, one short of a node block, one past it, the
    # largest s_layout), both radii settings, overlapping and coincident
    # nodes in a ±500 box, a ±50,000 box where d > ri + rj for almost every
    # pair, and near contact (below). Two launches must give the same bits.
    def k2_case(name, p, m, r):
        got = rep_ops.repulsion(p, m, 80.0, radii=r)
        check(torch.equal(got, rep_ops.repulsion(p, m, 80.0, radii=r)),
              f"K2 {name}: two launches differ")
        k2_rows_case(name, p, m, r, got)
        want = repulsion_chunked(p, m, 80.0, radii=r)
        ratio, err, fmax, fmed = k2_compare(torch, got, want,
                                            k2_row_scale(torch, p, m, 80.0, r))
        log(f"K2 {name}: worst |Δf|/Σ|f_ij| {ratio}, max|Δf| {err}, max|f| {fmax}, "
            f"median|f| {fmed}")
        check(ratio <= K2_TOL, f"K2 {name}: {ratio} > {K2_TOL}")
        return ratio

    def k2_rows_case(name, p, m, r, full):
        """K2's row entry: the halves and quarters a 2- and 4-rank layout
        owns, ragged and unaligned ranges and one row, bitwise the same
        rows of the full launch and run to run."""
        n = p.shape[0]
        for i0, nl in k_row_ranges(n):
            got = rep_ops.repulsion_rows(p, m, i0, nl, 80.0, radii=r)
            check(bits_equal(torch, got, full[i0:i0 + nl]),
                  f"K2 rows {name} [{i0}, {i0 + nl}): differ from the full launch's rows")
            check(bits_equal(torch, got, rep_ops.repulsion_rows(p, m, i0, nl, 80.0, radii=r)),
                  f"K2 rows {name} [{i0}, {i0 + nl}): two launches differ")

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
    log(f"K2 repulsion_nbody: worst |Δf_i|/Σ_j|f_ij| {worst} (tolerance {K2_TOL}); "
        "its row entry bitwise the full launch's rows and run to run on every case")

    # K3's raw entry: negatives, one hot pixel, every row dropped, the edge
    # pass's shape (runs of 8 samples, most of them one pixel), a row count
    # that is not a multiple of 4, pos and inc one element past a 16-byte
    # boundary (a scalar head), and pos alone past it (every row scalar).
    size = 11 * 1024 * 1024
    k3_cases = ("negatives", "one_pixel", "all_padding", "main", "runs", "ragged",
                "offset", "offset_pos")
    for kind in k3_cases:
        n = 524288 if kind in ("main", "runs") else 4099 if kind == "ragged" else 4096
        if kind == "negatives":
            p = rng.integers(-5, 300, n)
        elif kind == "one_pixel":
            p = np.full(n, 77)
        elif kind == "all_padding":
            p = np.full(n, i32max)
        elif kind == "runs":
            p = np.repeat(rng.integers(0, size, n // 8), 8)
            p[3::8] += 1
            p[::13] = i32max
        else:
            p = rng.integers(0, size + 1000, n)
        p = torch.as_tensor(p.astype(np.int32), device=dev)
        inc = torch.as_tensor(rng.integers(1, 6, n).astype(np.int32), device=dev)
        if kind.startswith("offset"):
            p = p[1:]
            inc = inc[1:] if kind == "offset" else inc[:-1].clone()
            check(p.data_ptr() % 16 == 4, "K3 offset case: pos is not one element past 16 B")
        base = torch.as_tensor(rng.integers(0, 3, size).astype(np.int32), device=dev)
        for incv in (inc, None):
            got = raster_ops.count_scatter_into(base.clone(), p, incv)
            want = count_scatter_into_ref(base.clone(), p, incv)
            check(torch.equal(got, want), f"K3 {kind}: kernel differs from plain")
            check(torch.equal(got, raster_ops.count_scatter_into(base.clone(), p, incv)),
                  f"K3 {kind}: two launches differ")
    log(f"K3 count_scatter: bitwise and run to run on {len(k3_cases)} cases × 2 increment "
        "forms")
    small_disk_checks(torch, np, rng)

    # K4: one pixel, zero extent, all dead, random incl. bad groups, 1024²;
    # against the disk-major walk: 40 groups, r = +inf (every pixel, even
    # for a centre at 1e30), NaN centres and radii, centres at ±1e30, integer
    # centres and radii (pixels exactly on the circle), r one ulp above 8,
    # one r = 128 disk alone, 2,000 coincident disks of one group (atomic
    # contention), a 1023×769 image, no disk, and the accumulating form on a
    # nonzero base. Two launches must give the same bits.
    up8 = float(np.nextafter(np.float32(8.0), np.float32(9.0)))
    k4_cases = ("one_pixel", "zero_extent", "all_dead", "random", "main", "groups_40",
                "r_inf", "nan", "far_centre", "integer", "ulp_above_8", "r128_alone",
                "coincident", "odd_image", "empty", "into")
    for kind in k4_cases:
        n, h, wd, ng = 96, 24, 40, 11
        g = rng.integers(0, ng, n)
        if kind == "one_pixel":
            cx, cy, r = np.full(n, 13.4), np.full(n, 7.2), rng.uniform(0.5, 0.6, n)
        elif kind == "zero_extent":
            cx, cy, r = np.full(n, 20.0), np.full(n, 12.0), rng.uniform(0, 6, n)
        elif kind == "all_dead":
            cx, cy, r = rng.uniform(0, wd, n), rng.uniform(0, h, n), -rng.uniform(0, 2, n)
        elif kind in ("random", "main", "groups_40", "into"):
            n, h, wd = (64, 1024, 1024) if kind == "main" else (300, 60, 100)
            ng = 40 if kind == "groups_40" else 11
            cx = rng.uniform(-10, wd + 10, n)
            cy = rng.uniform(-10, h + 10, n)
            r = rng.uniform(-2, 128 if kind == "main" else 40, n)
            g = rng.integers(-2, ng + 2, n)
        elif kind == "r_inf":
            cx, cy = [5, 50, 1e30, -1e30, np.inf, np.nan], [5, 20, 3, 3, 4, 4]
            r, g = [np.inf, 3, np.inf, np.inf, np.inf, np.inf], [0, 1, 2, 3, 4, 5]
        elif kind == "nan":
            cx, cy = [np.nan, 10, 10, 20, 30], [5, np.nan, 10, 12, 12]
            r, g = [10, 10, np.nan, 9, 12], [0, 1, 2, 3, 4]
        elif kind == "far_centre":  # r² finite below 1.8e19: d² overflows, nothing counts
            cx, cy = [1e30, -1e30, 1e30, 20, -1e30], [5, 5, -1e30, 1e30, 1e30]
            r, g = [1e18, 1e19, 5e18, 1.8e19, 1e15], [0, 1, 2, 3, 4]
        elif kind == "integer":
            n, h, wd = 400, 64, 96
            cx, cy = rng.integers(-5, wd + 5, n), rng.integers(-5, h + 5, n)
            r, g = rng.integers(1, 30, n), rng.integers(0, ng, n)
        elif kind == "ulp_above_8":
            n, h, wd = 200, 64, 96
            cx, cy = rng.integers(0, wd, n) + rng.choice([0.0, 0.5], n), rng.uniform(0, h, n)
            r, g = np.full(n, up8), rng.integers(0, ng, n)
        elif kind == "r128_alone":
            n, h, wd = 1, 1024, 1024
            cx, cy, r, g = [511.5], [300.25], [128.0], [7]
        elif kind == "coincident":
            n, h, wd = 2000, 256, 256
            cx, cy, r, g = np.full(n, 100.3), np.full(n, 130.6), np.full(n, 40.0), np.full(n, 3)
        elif kind == "odd_image":
            n, h, wd = 300, 769, 1023
            cx, cy = rng.uniform(-100, wd + 100, n), rng.uniform(-100, h + 100, n)
            r, g = rng.uniform(8, 128, n), rng.integers(0, ng, n)
        else:  # empty
            n, cx, cy, r, g = 0, [], [], [], []
        t = [torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (cx, cy, r)]
        gt = torch.as_tensor(np.asarray(g, np.int32), device=dev)
        if kind == "into":
            base = torch.as_tensor(rng.integers(0, 7, (ng, h, wd)).astype(np.int32), device=dev)
            got = raster_ops.disk_accum_into(base.clone(), *t, gt, ng)
            again = raster_ops.disk_accum_into(base.clone(), *t, gt, ng)
            want = disk_accum_into_ref(base.clone(), *t, gt, ng)
        else:
            got = raster_ops.disk_accum(*t, gt, ng, h, wd)
            again = raster_ops.disk_accum(*t, gt, ng, h, wd)
            want = disk_accum_ref(*t, gt, ng, h, wd)
        check(torch.equal(got, want), f"K4 {kind}: kernel differs from plain")
        check(torch.equal(got, again), f"K4 {kind}: two launches differ")
        if kind == "r_inf":
            check(bool((got[2:5] == 1).all()) and not bool(got[5].any()),
                  "K4 r_inf: an r = +inf disk does not cover the image")
    log(f"K4 disk_accum: bitwise and run to run on {len(k4_cases)} cases")
    grid_kernel_checks(torch, np, rng)
    torch.cuda.synchronize()


def small_disk_checks(torch, np, rng):
    """K3's small-disk entry against its plain version (the torch
    materialisation of every disk's box), bitwise and run to run."""
    from repro_torch.kernels.raster import ops as raster_ops
    from repro_torch.kernels.raster.ref import count_disks_into_ref

    dev = torch.device("cuda")
    cases = ("nan", "far", "radius_0_and_8", "integer", "half_pixel", "edges",
             "bad_groups", "empty", "odd_image", "main_shape")
    for kind in cases:
        m, hs, ws, ng = 200, 96, 128, 11
        cx, cy = rng.uniform(-10, ws + 10, m), rng.uniform(-10, hs + 10, m)
        r, g = rng.uniform(0.5, 8, m), rng.integers(0, ng, m)
        if kind == "nan":
            cx[::3], cy[1::3], r[2::7] = np.nan, np.nan, np.nan
        elif kind == "far":  # 1e30, ±2^30 and one pixel inside ±2^30
            far = np.array([1e30, -1e30, 2.0**30, -(2.0**30), 2.0**30 - 1, 1 - 2.0**30])
            cx[::2] = rng.choice(far, m // 2)
            cy[1::4] = rng.choice(far, m // 4)
        elif kind == "radius_0_and_8":
            r = np.where(np.arange(m) % 2 == 0, 0.0, 8.0)
        elif kind == "integer":  # pixels exactly on the circle
            cx, cy = rng.integers(-5, ws + 5, m), rng.integers(-5, hs + 5, m)
            r = rng.integers(1, 9, m)
        elif kind == "half_pixel":
            cx = rng.integers(-5, ws + 5, m) + 0.5
            cy = rng.integers(-5, hs + 5, m) + 0.5
            r = rng.integers(1, 17, m) / 2
        elif kind == "edges":  # centres within 9 px of an edge, outside too
            cx = rng.choice(np.array([-8.5, -3.25, 0.0, 0.75, ws - 0.5, ws + 4.0, ws + 8.75]), m)
            cy = rng.uniform(-9, hs + 9, m)
        elif kind == "bad_groups":
            g = rng.integers(-3, ng + 3, m)
        elif kind == "empty":
            m, cx, cy, r, g = 0, [], [], [], []
        elif kind == "odd_image":
            m, hs, ws = 5000, 769, 1023
            cx, cy = rng.uniform(-10, ws + 10, m), rng.uniform(-10, hs + 10, m)
            r, g = rng.uniform(0, 8, m), rng.integers(0, ng, m)
        else:  # the full path's node pass: 685,230 disks of 1 px in 1024²
            m, hs, ws = NODES, 1024, 1024
            cx, cy = rng.uniform(0, ws, m), rng.uniform(0, hs, m)
            r, g = np.ones(m), rng.integers(0, ng, m)
        t = [torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (cx, cy, r)]
        gt = torch.as_tensor(np.asarray(g, np.int32), device=dev)
        base = torch.as_tensor(rng.integers(0, 3, (ng, hs, ws)).astype(np.int32), device=dev)
        got = raster_ops.count_disks_into(base.clone(), *t, gt, ng)
        check(torch.equal(got, count_disks_into_ref(base.clone(), *t, gt, ng)),
              f"K3 disks {kind}: kernel differs from plain")
        check(torch.equal(got, raster_ops.count_disks_into(base.clone(), *t, gt, ng)),
              f"K3 disks {kind}: two launches differ")
        if kind == "radius_0_and_8":
            check(bool((got != base).any()), "K3 disks: the r = 8 disks drew nothing")
    log(f"K3 count_disks: bitwise and run to run on {len(cases)} cases")


def grid_kernel_checks(torch, np, rng):
    """K5–K8 against their plain versions on adversarial and full-shape
    inputs (the cases of the reference's kernel tests, and more)."""
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.kernels.grid.ref import bin_and_sort, far_field_ref, near_field_ref
    from repro_torch.kernels.grid.ref import near_field_rows as near_field_rows_ref

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
        # K6's row entry: bitwise the full launch's rows, the plain row form
        # and itself run to run.
        for i0, nl in k_row_ranges(n):
            rows = grid_ops.near_field_rows(pos_s, mass_s, cell_s, kr, w, i0, nl)
            check(bits_equal(torch, rows, got[i0:i0 + nl]),
                  f"K6 rows {name} [{i0}, {i0 + nl}): differ from the full launch's rows")
            check(bits_equal(torch, rows, grid_ops.near_field_rows(
                pos_s, mass_s, cell_s, kr, w, i0, nl)),
                f"K6 rows {name} [{i0}, {i0 + nl}): two launches differ")
            check(bits_equal(torch, rows, near_field_rows_ref(
                pos_s, mass_s, cell_s, kr, w, i0, nl)),
                f"K6 rows {name} [{i0}, {i0 + nl}): differ from the plain row form")
    log(f"K6 near_field: bitwise on {len(cases6)} cases, and run to run; its row entry "
        "bitwise the full launch's rows, the plain row form and run to run")

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
    layout_checks(torch, np, rng)

    cms_checks(torch, np, rng)


def attraction_old(torch, pos, dst, w, offsets):
    """The pre-change composition of FA2's sorted attraction on the card,
    from the fused entry's inputs: the [E, 2] terms materialised from the
    clamped sources (rows past ``offsets[n]`` are the trash sources, id n)
    and summed by K7's warp-per-segment kernel (ids sorted). Returns a
    function of no arguments, and the kept rows' (terms, sources)."""
    from repro_torch.kernels.segment import ops as seg_ops

    n, e = pos.shape[0], dst.shape[0]
    hi = int(offsets[n])
    src = torch.full((e,), n, dtype=torch.int32, device=pos.device)
    src[:hi] = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=pos.device), torch.diff(offsets).long(),
        output_size=hi - int(offsets[0]))

    def terms():
        pos_ext = torch.cat([pos, torch.zeros((1, 2), dtype=pos.dtype, device=pos.device)])
        return w[:, None] * (pos_ext[dst.long().clamp(0, n)] - pos_ext[src.long()])

    def old():
        return seg_ops.segment_sum(terms(), src, n, indices_are_sorted=True)

    return old, terms()[:hi], src[:hi]


def layout_checks(torch, np, rng):
    """K7's layout entries on edge cases, each bitwise its plain version on
    the CPU, bitwise the pre-change composition on the card (the stable
    sort, the sorted copy and the warp-per-segment kernel; for the
    attraction the materialised terms through it) and bitwise run to run:
    the layout build (negative and trash ids, empty segments, N = 1, no
    rows, a trash tail after a gap of 10^5 empty segments, which one
    thread writes); the per-edge sum at D = 2-4 (a thread a segment,
    SEG_SPAN-row chunks: one segment far longer than a chunk, segments
    across chunk edges) and D = 1, 5, 33, 63, 64, 128 (a warp a segment,
    float2 loads where D is even and the rows 8-byte aligned; a misaligned
    D = 64 view, one segment of 1,000 rows), through the sort's order and
    through a layout of sorted ids; the gather backward; the fused
    attraction (destinations past the zero row and negative, N = 1, a node
    with 5,000 edges, trash tails)."""
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import attraction_sum_ref, segment_sum_ref

    dev = torch.device("cuda")

    def same_layout(a, b):
        return bits_equal(torch, a.offsets, b.offsets) and bits_equal(torch, a.groups, b.groups) \
            and (a.perm is None and b.perm is None or bits_equal(torch, a.perm, b.perm))

    cases = (("mixed", 50000, 4096, 2), ("one_column", 40000, 200, 0), ("d3", 30000, 1000, 3),
             ("d4", 30000, 1000, 4), ("d5", 20000, 500, 5), ("d33", 8000, 300, 33),
             ("d63", 5000, 100, 63), ("wide64", 100000, 4000, 64), ("wide128", 20000, 300, 128),
             ("misaligned64", 20000, 400, 64), ("long_narrow", 60000, 300, 2),
             ("long_wide", 6000, 40, 64), ("empty_gaps", 30000, 500, 2),
             ("all_dropped", 5000, 16, 2), ("no_rows", 0, 10, 2), ("one_segment", 200000, 1, 2),
             ("big_gap", 5000, 100000, 2))
    for name, e, n, d in cases:
        ids = rng.integers(0, n, e)
        if name == "mixed":
            ids = rng.integers(-50, n + 50, e)
        elif name.startswith("long"):  # segment 5: many chunks' (narrow) or batches' rows
            ids[rng.permutation(e)[:10 * SEG_SPAN + 3 if 2 <= d <= 4 else 1000]] = 5
        elif name == "empty_gaps":
            ids = rng.choice(np.arange(10, n - 10, 3), e)
        elif name == "all_dropped":
            ids = np.where(rng.random(e) < 0.5, -1, n)
        elif name == "one_segment":
            ids = rng.integers(-1, 2, e)
        elif name == "big_gap":
            ids = np.where(rng.random(e) < 0.5, rng.integers(0, 100, e), n + 7)
        ids_t = torch.as_tensor(ids.astype(np.int32), device=dev)
        shape = (e,) if d == 0 else (e, d)
        if name == "misaligned64":
            flat = torch.as_tensor(rng.standard_normal(e * d + 1).astype(np.float32), device=dev)
            data = flat[1:].view(shape)
            check(data.data_ptr() % 8 == 4, "misaligned64: the view is 8-byte aligned")
        else:
            data = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 1e3,
                                   device=dev)
        lay = seg_ops.segment_layout(ids_t, n)
        check(same_layout(lay, seg_ops.segment_layout(ids_t, n)),
              f"K7 layout {name}: two builds differ")
        lay_c = seg_ops.segment_layout(ids_t.cpu(), n)
        check(bits_equal(torch, lay.perm.cpu(), lay_c.perm)
              and bits_equal(torch, lay.offsets.cpu(), lay_c.offsets)
              and bits_equal(torch, lay.groups.cpu(), lay_c.groups),
              f"K7 layout {name}: differs from the plain version on the CPU")
        got = seg_ops.segment_sum_edges(data, lay, n)
        check(bits_equal(torch, got, seg_ops.segment_sum_edges(data, lay, n)),
              f"K7 edges {name}: two launches differ")
        check(bits_equal(torch, got.cpu(), segment_sum_ref(data.cpu(), ids_t.cpu(), n)),
              f"K7 edges {name}: differs from the plain version on the CPU")
        if e:
            check(bits_equal(torch, got, seg_ops.segment_sum(data, ids_t, n)),
                  f"K7 edges {name}: differs from the pre-change composition")
        order = lay.perm.long()
        srt = seg_ops.segment_layout(ids_t[order], n, sorted=True)
        check(srt.perm is None and bits_equal(torch, srt.offsets, lay.offsets),
              f"K7 layout {name}: the sorted ids' offsets differ")
        check(bits_equal(torch, seg_ops.segment_sum_edges(data[order], srt, n), got),
              f"K7 edges {name}: the sum through sorted ids differs")
        if name in ("mixed", "wide64", "d5"):
            x = torch.as_tensor(rng.standard_normal((n,) + shape[1:]).astype(np.float32),
                                device=dev).requires_grad_(True)
            gout = data
            (gx,) = torch.autograd.grad(seg_ops.gather_rows(x, ids_t, lay), x, gout)
            xc = x.detach().cpu().requires_grad_(True)
            (gc,) = torch.autograd.grad(seg_ops.gather_rows(xc, ids_t.cpu()), xc, gout.cpu())
            check(bits_equal(torch, gx.cpu(), gc), f"K7 gather backward {name}: differs from "
                  "the plain version on the CPU")
    log(f"K7 layout entries: segment_offsets and segment_sum_edges bitwise on the CPU, the "
        f"pre-change composition and run to run on {len(cases)} cases; the gather backward "
        "bitwise on the CPU")

    acases = (("random", 50000, 400000), ("hub", 300, 60000), ("n1", 1, 100),
              ("out_of_range", 2000, 30000), ("all_trash", 100, 500))
    for name, n, e in acases:
        edges = rng.integers(0, n, (e, 2))
        edges[-e // 8:] = n  # trash-padded slots
        if name == "hub":
            edges[:5000, 0] = 7
        elif name == "out_of_range":
            edges[:50, 1] = n + 5
            edges[50:100, 1] = -3
            edges[100:150, 0] = -2
        elif name == "all_trash":
            edges[:] = n
        edges_t = torch.as_tensor(edges.astype(np.int32), device=dev)
        w = torch.as_tensor(rng.integers(1, 20, e).astype(np.float32), device=dev)
        pos = torch.as_tensor(rng.uniform(-1000, 1000, (n, 2)).astype(np.float32), device=dev)
        dst, w2, lay = fa2._attraction_edge_layout(edges_t, w, n)
        d2, w3, lay2 = fa2._attraction_edge_layout(edges_t, w, n)
        check(all(bits_equal(torch, a, b) for a, b in zip(
            (dst, w2, lay.offsets, lay.groups), (d2, w3, lay2.offsets, lay2.groups))),
              f"K7 attraction {name}: two layouts differ")
        got = seg_ops.attraction_sum(pos, dst, w2, lay)
        check(bits_equal(torch, got, seg_ops.attraction_sum(pos, dst, w2, lay)),
              f"K7 attraction {name}: two launches differ")
        cpu = attraction_sum_ref(pos.cpu(), dst.cpu(), w2.cpu(), lay.offsets.cpu())
        check(bits_equal(torch, got.cpu(), cpu),
              f"K7 attraction {name}: differs from the plain version on the CPU")
        old, _, _ = attraction_old(torch, pos, dst, w2, lay.offsets)
        check(bits_equal(torch, got, old()),
              f"K7 attraction {name}: differs from the pre-change composition")
    log(f"K7 attraction_sum: bitwise on the CPU, the pre-change composition and run to run "
        f"on {len(acases)} cases")


def cms_bound(torch, sketch, h, w):
    """Per bucket, 2γ(k)·(|s0| + Σ|w|) with γ(k) = k·u / (1 − k·u), u = 2⁻²⁴
    and k the bucket's terms, the sketch's included: the most two sums of
    the same terms in two orders can differ."""
    keep = (h >= 0) & (h < sketch.shape[1])
    r = torch.arange(h.shape[0], device=h.device)[:, None].expand_as(h)[keep]
    b = h[keep].long()
    cnt = torch.ones_like(sketch, dtype=torch.float64).index_put_(
        (r, b), torch.ones_like(b, dtype=torch.float64), accumulate=True)
    absum = sketch.double().abs().index_put_(
        (r, b), w.double().abs()[None, :].expand_as(h)[keep], accumulate=True)
    m = cnt * 2.0**-24
    return 2 * m / (1 - m) * absum


def cms_checks(torch, np, rng):
    """K8's two entries against their plain versions: ``update_hashed``
    (buckets given) and ``update`` (keys hashed in the kernel), bitwise
    where every bucket sum of integer weights stays below 2²⁴, and run to
    run on every case."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.cms.ref import cms_update_ref

    dev = torch.device("cuda")
    # (name, rows, cols, n). "above_2_24": one bucket sums to ≈ 3.5e7;
    # "wide_int": integer weights up to 2^30 (the kernel's direct int64
    # adds, sums far above 2^24); "float_weights": fractional weights.
    cases = (("random", 4, 512, 20000), ("all_padding", 4, 256, 3000),
             ("one_bucket", 4, 64, 50000), ("out_of_range", 2, 100, 5000),
             ("cols_34000", 4, 34000, 200000), ("n_0", 4, 6594, 0), ("n_1", 4, 6594, 1),
             ("above_2_24", 4, 6594, 5_000_000), ("wide_int", 3, 1000, 30000),
             ("float_weights", 4, 6594, 100000), ("main_shape", 4, 6594, NODES))
    for name, rows, cols, n in cases:
        h = rng.integers(0, cols, (rows, n))
        h[:, ::7] = -1  # padding, in every row
        if name == "all_padding":
            h[:] = -1
        elif name in ("one_bucket", "above_2_24"):
            h[:] = 3
        elif name == "out_of_range":
            h = rng.integers(-5, cols + 5, (rows, n))
        h = torch.as_tensor(h.astype(np.int32), device=dev)
        if name == "float_weights":
            w = rng.uniform(0, 3, n)
        elif name == "wide_int":
            w = rng.integers(-(2**30), 2**30, n)
        else:
            w = rng.integers(0, 60, n)
        w = torch.as_tensor(w.astype(np.float32), device=dev)
        sketch = torch.as_tensor(rng.integers(0, 9, (rows, cols)).astype(np.float32),
                                 device=dev)
        got = cms_ops.update_hashed(sketch, h, w)
        again = cms_ops.update_hashed(sketch, h, w)
        want = cms_update_ref(sketch, h, w)
        if name == "float_weights":
            # Fractional weights add by float atomics, in no fixed order:
            # each launch is within rounding of the plain version, and the
            # two launches are not held bitwise (csrc/cms_update.cu).
            bound = cms_bound(torch, sketch, h, w)
            for x in (got, again):
                check(bool(((x.double() - want.double()).abs() <= bound).all()),
                      "K8 float weights: a bucket differs by more than 2γ(k)·Σ|x|")
            log(f"K8 float weights: {int((got != again).sum())} of {got.numel()} buckets "
                "differ between two launches, all within 2γ(k)·Σ|x| of the plain version")
            continue
        check(bits_equal(torch, got, again), f"K8 {name}: two launches differ")
        if name in ("above_2_24", "wide_int"):
            err = (got.double() - want.double()).abs()
            check(bool((err <= cms_bound(torch, sketch, h, w)).all()),
                  f"K8 {name}: a bucket differs by more than 2γ(k)·Σ|x|")
        else:
            check(bits_equal(torch, got, want), f"K8 {name}: kernel differs from plain version")
        if name in ("above_2_24", "wide_int"):
            # Integer weights: the exact bucket sum, rounded once, plus the sketch.
            keep = h >= 0
            r = torch.arange(rows, device=dev)[:, None].expand_as(h)[keep]
            exact = torch.zeros((rows, cols), dtype=torch.int64, device=dev).index_put_(
                (r, h[keep].long()), w.long()[None, :].expand_as(h)[keep], accumulate=True)
            once = torch.where(exact != 0, sketch + exact.to(torch.float32), sketch)
            check(bits_equal(torch, got, once), f"K8 {name}: not the exact sum rounded once")
    log(f"K8 cms_update: {len(cases) - 1} integer-weight cases run to run, bitwise where "
        "bucket sums stay below 2^24, else the exact sum rounded once and within 2γ(k)·Σ|x|")

    # The keys-in entry against its plain version (hash + index_put_) and,
    # through core.cms.update, the pipeline's call: -1 padding, repeated
    # keys, 34,000 columns, all padding, n = 0 and 1, one key above 2^24.
    cases = (("mixed", 6594, 50000), ("repeated", 256, 20000), ("cols_34000", 34000, 200000),
             ("all_padding", 256, 3000), ("n_0", 6594, 0), ("n_1", 6594, 1),
             ("above_2_24", 6594, 5_000_000), ("main_shape", 6594, NODES))
    for name, cols, n in cases:
        cfg = cms_lib.CMSConfig(rows=4, cols=cols)
        keys = rng.integers(0, 200, n)
        if name in ("repeated", "above_2_24"):
            keys = rng.choice(np.array([3, 3, 3, 17, 2**31 - 1]), n)
        keys[::5] = -1
        if name == "all_padding":
            keys[:] = -1
        keys = torch.as_tensor(keys.astype(np.int32), device=dev)
        w = torch.as_tensor(rng.integers(1, 50, n).astype(np.float32), device=dev)
        s0 = torch.as_tensor(rng.integers(0, 9, (4, cols)).astype(np.float32), device=dev)
        got = cms_lib.update(s0, keys, w, cfg)
        check(bits_equal(torch, got, cms_ops.update(s0, keys, w, cfg)),
              f"K8 keys {name}: two launches differ")
        h = cms_ops.hashed_buckets(keys, cfg)
        want = cms_update_ref(s0, h, w)
        if name == "above_2_24":
            err = (got.double() - want.double()).abs()
            check(bool((err <= cms_bound(torch, s0, h, w)).all()),
                  "K8 keys above 2^24: a bucket differs by more than 2γ(k)·Σ|x|")
            check(bits_equal(torch, got, cms_ops.update_hashed(s0, h, w)),
                  "K8 keys above 2^24: differs from the hashed entry")
        else:
            check(bits_equal(torch, got, want), f"K8 keys {name}: kernel differs from plain")
    log(f"K8 cms_update_keys: bitwise on {len(cases) - 1} cases, run to run on {len(cases)}, "
        "one bucket above 2^24 equal to the hashed entry and within 2γ(k)·Σ|x|")


# ------------------------------------------------------------- phase 4
class Capture:
    """Records kernel inputs by wrapping the module attribute each caller
    looks up (inputs cloned before the call): per site the largest call,
    or the latest one for the sites whose calls all have one size (the
    grid path's, and K1's, whose last merge holds the fullest state).
    ``recording(tag)`` files them under ``site + tag``, so a second path's
    inputs do not overwrite the main path's. Launch counts stay with the
    wrappers themselves (``repro_torch.kernels.build.LAUNCHES``). The CMS
    site is the pipeline's ``core.cms.update``, which launches K8's keys-in
    entry."""

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
            (merge_ops, "merge_place", "merge_scatter", 0, True),
            (rep_ops, "repulsion", "repulsion_nbody", 0, False),
            (raster_ops, "count_scatter_into", "count_scatter", 1, False),
            (raster_ops, "count_disks_into", "count_disks", 1, False),
            (raster_ops, "disk_accum_into", "disk_accum", 1, False),
            (grid_ops, "far_field", "far_field", 0, True),
            (grid_ops, "near_field_sorted", "near_field", 0, True),
            (seg_ops, "segment_sum", "segment_sum", 0, True),
            (seg_ops, "segment_layout", "segment_offsets", 0, True),
            (seg_ops, "attraction_sum", "attraction_sum", 1, True),
            (seg_ops, "segment_sum_edges", "segment_sum_edges", 0, True),
            (cms_lib, "update", "cms_update", 1, False),
        ]
        # Arguments recorded by shape only (a "meta" tensor): the node
        # pass's accumulator (K3's disk entry and K4), whose 46 MB copy
        # would stay allocated through the full path and count in its peak
        # memory.
        self.shape_only = {"count_disks": (0,), "disk_accum": (0,)}
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
    def recording(self, tag: str = ""):
        saved = []
        for mod, attr, key, arg, latest in self.sites:
            real = getattr(mod, attr)

            def wrapper(*args, _real=real, _key=key, _arg=arg, _latest=latest, **kw):
                size = args[_arg].numel()
                best = self.calls.get(_key + tag)
                if best is None or size > best[0] or (_latest and size == best[0]):
                    meta = self.shape_only.get(_key, ())
                    cl = tuple(x if not isinstance(x, self.torch.Tensor)
                               else x.to("meta") if i in meta else x.clone()
                               for i, x in enumerate(args))
                    self.calls[_key + tag] = (size, cl, dict(kw))
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


# The reference's uniform draw for key 0, shape (4, 2), in [-1000, 1000)
# (release 0.9.0 of its array library: threefry2x32, partitionable),
# flattened, as bit patterns.
REFERENCE_UNIFORM_BITS = {
    "float32": (0x445FD560, 0x446F4A39, 0xC3A7B561, 0xC27AA6FE,
                0x430BC705, 0xC4273F9D, 0xC3BDCE2E, 0x43BD7B05),
    "bfloat16": (0x4394, 0x4310, 0xC42C, 0xC414, 0x43D4, 0xC3F2, 0xC200, 0x4476),
}
# The reference's float32 normal draw for key 0, shape (4, 2), flattened, as
# bit patterns, and its split of key 0 into 3 (the same release).
REFERENCE_NORMAL_BITS = (0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222,
                         0x3E34512C, 0xBF78DAD7, 0xBEFD97CC, 0x3EFD1F31)
REFERENCE_SPLIT = [(1797259609, 2579123966), (928981903, 3453687069),
                   (4146024105, 2718843009)]
NORMAL_CHECK_SIZE = 1 << 20  # values of the card-against-CPU normal draw
NORMAL_TIMED = ("yi-6b embed", (64000, 4096))  # the weights' draw timed on the card


def prng_checks(torch, sizes: dict, seed: int) -> None:
    """The seeded draws (``core/prng``) on the card: the layouts' uniform
    starts the same bits as on the CPU at each path's size, and the
    reference's recorded values for key 0; the weights' normal draw
    (``init_params``) the CPU's bits at NORMAL_CHECK_SIZE values, a draw
    in chunks the whole draw's, key 0's the reference's recorded bits, and
    ``split`` the reference's. Times the full path's uniform draw and
    NORMAL_TIMED's normal draw on the card."""
    from repro_torch.core import prng

    k = prng.key(seed)
    for name, n in sizes.items():
        card = prng.uniform(k, (n, 2), -1000.0, 1000.0, device="cuda")
        same = bits_equal(torch, card.cpu(), prng.uniform(k, (n, 2), -1000.0, 1000.0))
        log(f"prng uniform ({n}, 2) float32, {name}: card bits equal the CPU's: {same}")
        check(same, f"prng: the card's draw for the {name} differs from the CPU's")
    for dtype, want in REFERENCE_UNIFORM_BITS.items():
        dt = getattr(torch, dtype)
        ibits = torch.int32 if dt == torch.float32 else torch.int16
        mask = (1 << (8 * dt.itemsize)) - 1
        for dev in ("cuda", "cpu"):
            got = prng.uniform(prng.key(0), (4, 2), -1000.0, 1000.0, dt, dev)
            got = tuple(int(b) & mask for b in got.view(ibits).flatten().tolist())
            log(f"prng uniform key 0 (4, 2) {dtype} on {dev}: "
                f"{' '.join(f'{b:#x}' for b in got)}; the reference's: {got == want}")
            check(got == want, f"prng: {dtype} draw on {dev} differs from the reference's")
    n = max(sizes.values())
    ms = cuda_ms(torch, lambda: prng.uniform(k, (n, 2), -1000.0, 1000.0, device="cuda"), 5)
    log(f"prng uniform ({n}, 2) float32 on the card: {ms:.4f} ms")

    split = prng.split(prng.key(0), 3)
    log(f"prng split of key 0 into 3: {split}; the reference's: {split == REFERENCE_SPLIT}")
    check(split == REFERENCE_SPLIT, "prng: split of key 0 differs from the reference's")
    for dev in ("cuda", "cpu"):
        got = prng.normal(prng.key(0), (4, 2), device=dev)
        got = tuple(int(b) & 0xFFFFFFFF for b in got.view(torch.int32).flatten().tolist())
        log(f"prng normal key 0 (4, 2) float32 on {dev}: "
            f"{' '.join(f'{b:#x}' for b in got)}; the reference's: {got == REFERENCE_NORMAL_BITS}")
        check(got == REFERENCE_NORMAL_BITS, f"prng: normal draw on {dev} differs from the "
                                            "reference's")
    card = prng.normal(k, (NORMAL_CHECK_SIZE,), device="cuda")
    t0 = time.perf_counter()
    host = prng.normal(k, (NORMAL_CHECK_SIZE,))
    host_s = time.perf_counter() - t0
    same = bits_equal(torch, card.cpu(), host)
    log(f"prng normal ({NORMAL_CHECK_SIZE},) float32: card bits equal the CPU's: {same} "
        f"(the CPU's draw {host_s:.3f} s)")
    check(same, "prng: the card's normal draw differs from the CPU's")
    chunk = prng.CHUNK
    try:
        prng.CHUNK = NORMAL_CHECK_SIZE // 3 + 1  # three chunks, the last one shorter
        same = bits_equal(torch, prng.normal(k, (NORMAL_CHECK_SIZE,), device="cuda"), card)
    finally:
        prng.CHUNK = chunk
    log(f"prng normal ({NORMAL_CHECK_SIZE},) on the card in three chunks equals the whole "
        f"draw: {same}")
    check(same, "prng: a normal draw in chunks differs from the whole draw")
    del card, host
    name, shape = NORMAL_TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: prng.normal(k, shape, device="cuda"), 1)
    log(f"prng normal {shape} float32 ({name}, {math.prod(shape)} values) on the card: "
        f"{ms:.4f} ms, peak {torch.cuda.max_memory_allocated()} bytes")
    torch.cuda.empty_cache()


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
    scfg = repro_torch.StreamConfig(chunk_size=MAIN_CHUNK)

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
    # Every output is deterministic: labels, the supergraph, the layout
    # (the attraction sums in a fixed order, K7) and so the image.
    check(np.array_equal(rec.labels, res.labels)
          and rec.n_superedges == res.n_superedges and rec_image.shape == image.shape,
          "recording run differs from the measured run")
    bitwise = bool(np.array_equal(rec.positions.view(np.uint8), res.positions.view(np.uint8)))
    log(f"main path layout bitwise run to run: {bitwise} (max|Δ| "
        f"{float(np.abs(rec.positions - res.positions).max())} of "
        f"{float(np.abs(res.positions).max())})")
    check(bitwise, "main path: two runs' positions differ")
    check(np.array_equal(rec_image, image), "main path: two runs' images differ")
    n_sn = res.n_supernodes
    s_layout = min(max(1 << (max(n_sn, 2) - 1).bit_length(), 64), cfg.s_cap)
    log(f"n_supernodes {n_sn} n_superedges {res.n_superedges} s_layout {s_layout} "
        f"modularity {res.modularity}")
    prng_checks(torch, {"main path supergraph": s_layout, "full path": n},
                cfg.layout.seed)
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
    for k in sorted(MAIN_KERNELS):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
    check(launches["cms_update_keys"] == 1, "K8 did not launch once on the main path")
    its = res.timings["layout_iterations"]
    check(launches["attraction_sum"] == its,
          f"K7's attraction launched {launches['attraction_sum']} times in {its} iterations")
    check(launches["segment_offsets"] == 1 and launches["segment_sum_edges"] == 0,
          f"the main path built {launches['segment_offsets']} segment layouts (1: the "
          f"attraction's) and summed {launches['segment_sum_edges']} times through one")
    check(peak <= MAIN_PEAK_BYTES, f"main-path peak {peak} bytes above {MAIN_PEAK_BYTES}")
    # The serve phase takes this result; its supergraph waits on the host so
    # that the full path's peak memory counts nothing of it.
    res.supergraph = dataclasses.replace(
        res.supergraph, **{f.name: getattr(res.supergraph, f.name).cpu()
                           for f in dataclasses.fields(res.supergraph)})
    return launches, wall, res, cfg


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
    check(launches["segment_offsets"] == 1 and launches["segment_sum_edges"] == 0,
          f"the full path built {launches['segment_offsets']} segment layouts (1: the "
          f"attraction's) and summed {launches['segment_sum_edges']} times through one")
    check(launches["count_scatter"] == rstats.chunks and launches["count_disks"] == 1,
          f"K3 on the full path: {launches['count_scatter']} raw launches for "
          f"{rstats.chunks} edge chunks, {launches['count_disks']} node passes")
    check(peak < FULL_RENDER_PEAK_BYTES,
          f"full-path render_arrays peak {peak} bytes, not below {FULL_RENDER_PEAK_BYTES}")
    check(pos.shape == (n, 2) and groups.shape == (n,), "full path output shapes")
    check(np.isfinite(pos).all(), "non-finite full-graph positions")
    frac, counts = raster.image_summary(image)
    log(f"full image non-background fraction {frac}, palette colors {(counts > 0).sum()}, "
        f"edges streamed {rstats.edges_streamed}")
    check(frac >= 0.01, f"full image is {frac:.4f} non-background (< 1%)")
    check((counts > 0).sum() >= 3, "full image shows fewer than 3 palette colors")

    # The whole path again: the layout must be the same bits (every force
    # kernel and the attraction's sum add in a fixed order).
    again, again_groups = repro_torch.full_layout_colored(edges, n, cfg,
                                                          iterations=FULL_ITERATIONS,
                                                          device="cuda")
    bitwise = bool(np.array_equal(again.view(np.uint8), pos.view(np.uint8)))
    log(f"full path layout bitwise run to run: {bitwise} (max|Δ| "
        f"{float(np.abs(again - pos).max())} of {float(np.abs(pos).max())})")
    check(bitwise and np.array_equal(again_groups, groups),
          "full path: two runs' positions or groups differ")
    del again, again_groups

    t0 = time.perf_counter()
    pos0 = fa2.init_positions(n, cfg.layout.seed, device="cuda").cpu().numpy()
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
    s0 = fa2.init_positions(m, scfg.layout.seed, device="cuda").cpu().numpy()
    sq = {name: layout_quality(np, p, small, m) for name, p in (("initial", s0), ("final", spos))}
    log(f"6,000-node full layout quality {json.dumps(sq)}")
    check(sq["final"]["neighborhood"] > 2 * sq["initial"]["neighborhood"]
          and sq["final"]["stress"] < sq["initial"]["stress"],
          "6,000-node full layout: neighbourhoods or stress no better than its start")

    record_grid_inputs(torch, cap, edges, pos)
    record_render_inputs(cap, edges, pos, groups)
    return launches


def record_render_inputs(cap: Capture, edges, pos, groups):
    """One node pass and one edge chunk of the full path's render, from its
    final layout ``pos``, recording K3's inputs in ``cap`` under
    ``"<site>@full"`` (outside any measured run)."""
    import numpy as np

    import repro_torch

    with cap.recording("@full"):
        repro_torch.render_arrays(pos, np.full(NODES, 2.0), groups, edges[:1 << 16],
                                  device="cuda")


def record_grid_inputs(torch, cap: Capture, edges, pos):
    """One grid iteration from the full path's final layout ``pos``,
    through ``repro_torch.layout``, recording K5–K7's inputs in ``cap``
    (outside any measured run); K7's attraction and its layout build under
    ``"attraction_sum@full"`` and ``"segment_offsets@full"``, beside the
    main path's."""
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
    keys = ("attraction_sum", "segment_offsets")
    main_calls = {k: cap.calls.pop(k) for k in keys}
    with cap.recording():
        repro_torch.layout(edges_t, torch.ones(e, device="cuda"), mass, n, lcfg,
                           pos0=torch.as_tensor(pos, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    for k in keys:
        cap.calls[k + "@full"] = cap.calls.pop(k)
    cap.calls.update(main_calls)
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


# ------------------------------------------------------------- phase 5b
# Half-width layouts (``FA2Config.dtype``). K2's two entries and K7's fused
# attraction read a bfloat16 or float16 layout in its own type, compute in
# float32 as for a float32 layout and round each output once; their plain
# versions widen, compute and round the same way. Per row and axis, K2
# against its plain version on the card: |Δf| ≤ K2_TOL·Σ_j|f_ij| + one ulp
# of the output type at |f_plain| (the two float32 sums' K2_TOL, then each
# side's one rounding). The attraction is bitwise its plain version on the
# CPU, as in float32 (the same terms, order and rounding).
HALF_TYPES = {"bfloat16": 7, "float16": 10}  # type → explicit mantissa bits
# The bfloat16 runs: the main path's supergraph layout (its 100 iterations),
# the full path's grid layout (its 500), and a small layout at the CPU
# tests' size (tests/test_torch_fa2.py: 150 nodes, 600 edges, 3
# iterations) on the card against the CPU within 2⁻⁷·max|pos|.
HALF_CPU_NODES, HALF_CPU_EDGES, HALF_CPU_ITERATIONS, HALF_CPU_TOL = 150, 600, 3, 2.0**-7


def half_ulp(torch, a, b):
    """One ulp of the half-width type of ``a`` and ``b`` at max(|a|, |b|),
    as float32 (the least subnormal's at 0): two values within d of each
    other round to values within d + that ulp."""
    bits = HALF_TYPES[str(a.dtype).removeprefix("torch.")]
    least = torch.finfo(a.dtype).smallest_normal * 2.0**-bits
    _, e = torch.frexp(torch.maximum(a.float().abs(), b.float().abs()))
    return torch.clamp(torch.ldexp(torch.ones_like(a, dtype=torch.float32), e - 1 - bits),
                       min=least)


def half_inputs(torch, np, cap: Capture, name: str):
    """K2's and the attraction's inputs in type ``name``: bfloat16, the
    main and full paths' recorded inputs cast; float16, the recorded
    main-path shapes and layout with seeded values in float16's range (the
    recorded positions and masses would overflow its forces: spread wide,
    radii below the nearest distances, small weights on small
    coordinates). Returns (K2's (pos, mass, kr, radii), {tag: the
    attraction's (pos, dst, w, layout)})."""
    t = getattr(torch, name)
    _, (p, m, kr), kw = cap.calls["repulsion_nbody"]
    radii = kw.get("radii")
    att = {tag: cap.calls["attraction_sum" + tag][1] for tag in ("", "@full")}
    if name == "bfloat16":
        k2 = (p.to(t), m.to(t), kr, None if radii is None else radii.to(t))
        return k2, {tag: (pos.to(t), dst, w.to(t), lay) for tag, (pos, dst, w, lay) in att.items()}
    rng = np.random.default_rng(SEED)

    def uniform(shape, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                               device=p.device).to(t)

    n = p.shape[0]
    k2 = (uniform((n, 2), -16000, 16000), uniform(n, 0.5, 2.0), kr, uniform(n, 0.0, 0.05))
    pos, dst, w, lay = att[""]
    return k2, {"": (uniform(tuple(pos.shape), -10, 10), dst, uniform(tuple(w.shape), 0.05, 0.5),
                     lay)}


def half_kernel_checks(torch, np, cap: Capture) -> dict:
    """K2 (whole, and its row entry on rank 1's half) and K7's fused
    attraction in bfloat16 and float16 against their plain versions (see
    above), each finite, in the layout's type and bitwise run to run; the
    row entry bitwise the whole launch's rows. Returns the worst K2 error
    per type, as |Δf| / (K2_TOL·Σ_j|f_ij| + ulp)."""
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.repulsion.ref import repulsion_chunked
    from repro_torch.kernels.segment.ref import attraction_sum_ref

    worst = {}
    k2 = cap.fn("repulsion_nbody")
    k7 = cap.fn("attraction_sum")
    for name in HALF_TYPES:
        t = getattr(torch, name)
        (p, m, kr, radii), att = half_inputs(torch, np, cap, name)
        got = k2(p, m, kr, radii=radii)
        check(got.dtype == t and bool(torch.isfinite(got).all()),
              f"K2 {name}: dtype {got.dtype}, finite {bool(torch.isfinite(got).all())}")
        check(bits_equal(torch, got, k2(p, m, kr, radii=radii)), f"K2 {name}: two launches differ")
        plain = repulsion_chunked(p, m, kr, radii=radii)
        scale = k2_row_scale(torch, p.float(), m.float(), kr,
                             None if radii is None else radii.float())
        bound = K2_TOL * scale + half_ulp(torch, got, plain)
        err = (got.float() - plain.float()).abs()
        worst[name] = float((err / bound).max())
        log(f"K2 {name} n={p.shape[0]}: worst |Δf| / (K2_TOL·Σ|f_ij| + ulp) {worst[name]}, "
            f"max|Δf| {float(err.max())}, max|f| {float(plain.float().abs().max())}")
        check(bool((err <= bound).all()), f"K2 {name}: |Δf| above K2_TOL·Σ|f_ij| + one ulp")
        n = p.shape[0]
        i0, nl = n // MD_RANKS, n - n // MD_RANKS
        rows = rep_ops.repulsion_rows(p, m, i0, nl, kr, radii=radii)
        check(bits_equal(torch, rows, got[i0:i0 + nl]),
              f"K2 rows {name}: differ from the whole launch's rows")
        for tag, (pos, dst, w, lay) in att.items():
            a = k7(pos, dst, w, lay)
            check(a.dtype == t and bool(torch.isfinite(a).all()),
                  f"K7 attraction{tag} {name}: dtype {a.dtype} or non-finite")
            check(bits_equal(torch, a, k7(pos, dst, w, lay)),
                  f"K7 attraction{tag} {name}: two launches differ")
            cpu = attraction_sum_ref(pos.cpu(), dst.cpu(), w.cpu(), lay.offsets.cpu())
            check(bits_equal(torch, a.cpu(), cpu),
                  f"K7 attraction{tag} {name}: differs from the plain version on the CPU")
            log(f"K7 attraction{tag} {name} E={dst.shape[0]} n={pos.shape[0]}: bitwise the "
                f"plain version on the CPU and run to run")
    return worst


class PosWatch:
    """Wraps K2's two entries and K7's attraction (the module attributes FA2
    calls through) to record the type and address of every ``pos`` handed
    to them, and, as a dispatch mode, counts the operations that make a
    float32 tensor of the layout's shape from a bfloat16 one (a widened
    copy of pos)."""

    def __init__(self, torch, n: int):
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.kernels.repulsion import ops as rep_ops
        from repro_torch.kernels.segment import ops as seg_ops

        self.torch, self.n, self.seen, self.copies = torch, n, [], 0
        self.sites = [(rep_ops, "repulsion"), (rep_ops, "repulsion_rows"),
                      (seg_ops, "attraction_sum")]
        watch = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                watch.count(args, out)
                return out

        self.mode = Mode()

    def count(self, args, out):
        torch, shape = self.torch, (self.n, 2)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not any(isinstance(o, torch.Tensor) and o.dtype == torch.float32
                   and tuple(o.shape) == shape for o in outs):
            return
        if any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
               and tuple(a.shape) == shape for a in args):
            self.copies += 1

    @contextlib.contextmanager
    def watching(self, copies: bool):
        """Record the kernels' pos while inside; with ``copies``, count the
        widened copies too (the dispatch mode costs ≈ 0.1 s an iteration
        at the main path's size)."""
        saved = []
        for mod, attr in self.sites:
            real = getattr(mod, attr)

            def wrapper(pos, *args, _real=real, _attr=attr, **kw):
                self.seen.append((_attr, pos.dtype, pos.data_ptr()))
                return _real(pos, *args, **kw)

            saved.append((mod, attr, real))
            setattr(mod, attr, wrapper)
        try:
            with self.mode if copies else contextlib.nullcontext():
                yield self
        finally:
            for mod, attr, real in saved:
                setattr(mod, attr, real)


def half_layout_phase(torch, np, cap: Capture, edges, res, cfg) -> dict:
    """Half-width layouts on the card: the kernel checks above; the main
    path's supergraph laid out in bfloat16 by ``layout_supergraph`` (100
    iterations: K2 and the attraction launched 100 times each on bfloat16
    pos, no float32 copy of pos made, finite, bitwise run to run) and
    drawn by ``BGVResult.render``; the full path's grid layout in bfloat16
    (500 iterations, finite, bitwise run to run); a 3-iteration bfloat16
    layout at the CPU tests' size against the CPU within 2⁻⁷·max|pos|.
    Returns the runs' launches by path, the main run's positions and the
    numbers it printed."""
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.core.pipeline import layout_supergraph
    from repro_torch.device import host_array
    from repro_torch.graph.utils import degrees, pad_edges
    from repro_torch.render import raster

    out = {"k2_worst": half_kernel_checks(torch, np, cap)}
    sg = dataclasses.replace(res.supergraph, **{
        f.name: getattr(res.supergraph, f.name).to("cuda")
        for f in dataclasses.fields(res.supergraph)})
    hcfg = dataclasses.replace(cfg, layout=dataclasses.replace(cfg.layout, dtype="bfloat16"))
    s_layout = min(max(1 << (max(res.n_supernodes, 2) - 1).bit_length(), 64), cfg.s_cap)
    # The widened copies are counted on a 3-iteration run of the same path
    # (every iteration runs the same operations), the rest on the 100.
    watch = PosWatch(torch, s_layout)
    short = dataclasses.replace(hcfg, layout=dataclasses.replace(hcfg.layout, iterations=3))
    with watch.watching(copies=True):
        layout_supergraph(sg, short, device="cuda")
    out["pos_copies"] = watch.copies
    watch = PosWatch(torch, s_layout)
    torch.cuda.synchronize()
    cap.reset()
    t0 = time.perf_counter()
    with watch.watching(copies=False):
        pos, its = layout_supergraph(sg, hcfg, device="cuda")
    torch.cuda.synchronize()
    out["main_layout_s"] = time.perf_counter() - t0
    launches = cap.counts()
    log(f"bfloat16 main-path layout: {its} iterations in {out['main_layout_s']:.3f} s "
        f"(the float32 main path's layout_s {res.timings['layout_s']:.3f} s), launches K2 "
        f"{launches['repulsion_nbody']}, attraction {launches['attraction_sum']}; widened "
        f"copies of pos in 3 iterations {out['pos_copies']}")
    check(pos.dtype == torch.bfloat16 and bool(torch.isfinite(pos).all()),
          f"bfloat16 main-path layout: dtype {pos.dtype} or non-finite")
    check(its == ITERATIONS and launches["repulsion_nbody"] == its
          and launches["attraction_sum"] == its,
          f"bfloat16 main-path layout: {its} iterations, K2 {launches['repulsion_nbody']}, "
          f"attraction {launches['attraction_sum']} launches")
    types = {(attr, str(dt)) for attr, dt, _ in watch.seen}
    check(types == {("repulsion", "torch.bfloat16"), ("attraction_sum", "torch.bfloat16")},
          f"bfloat16 main-path layout: the kernels were handed {sorted(types)}")
    # Each iteration hands the attraction and then K2 the same bfloat16 pos.
    ptrs = [p for _, _, p in watch.seen]
    check(len(ptrs) == 2 * its and ptrs[0::2] == ptrs[1::2],
          "bfloat16 main-path layout: K2 and the attraction read different pos")
    check(out["pos_copies"] == 0,
          f"bfloat16 main-path layout: {out['pos_copies']} float32 copies of pos")
    again, _ = layout_supergraph(sg, hcfg, device="cuda")
    check(bits_equal(torch, again, pos), "bfloat16 main-path layout: two runs differ")
    hres = dataclasses.replace(res, positions=host_array(pos), timings=dict(res.timings))
    with tempfile.TemporaryDirectory() as tmp:
        image, _ = hres.render(str(Path(tmp) / "bf16.png"))
    frac, counts = raster.image_summary(image)
    log(f"bfloat16 main-path image non-background {frac}, palette colors {(counts > 0).sum()}")
    check(frac >= 0.01 and (counts > 0).sum() >= 3, "bfloat16 main-path image")
    out["positions"] = hres.positions
    del again, sg

    # The full path's grid layout in bfloat16 (K5 and K6 widen to float32).
    n, e = NODES, len(edges)
    edges_t = torch.as_tensor(pad_edges(edges, e, n), device="cuda")
    mass = degrees(edges_t, n).to(torch.float32) + 1.0
    w = torch.ones(e, device="cuda")
    lcfg = fa2.FA2Config(iterations=FULL_ITERATIONS, repulsion="grid", grid_size=GRID,
                         grid_window=WINDOW, use_radii=False, dtype="bfloat16")
    torch.cuda.synchronize()
    cap.reset()
    t0 = time.perf_counter()
    gpos, _, gits = fa2.layout(edges_t, w, mass, n, lcfg, device="cuda")
    torch.cuda.synchronize()
    out["full_layout_s"] = time.perf_counter() - t0
    full = cap.counts()
    log(f"bfloat16 full-path grid layout: {gits} iterations in {out['full_layout_s']:.3f} s, "
        f"launches {json.dumps({k: v for k, v in full.items() if v})}")
    check(gpos.dtype == torch.bfloat16 and bool(torch.isfinite(gpos).all()),
          "bfloat16 full-path layout: dtype or non-finite")
    for k in FULL_KERNELS:
        check(full[k] == gits == FULL_ITERATIONS,
              f"bfloat16 full-path layout: {k} launched {full[k]} times in {gits} iterations")
    gagain, _, _ = fa2.layout(edges_t, w, mass, n, lcfg, device="cuda")
    check(bits_equal(torch, gagain, gpos), "bfloat16 full-path layout: two runs differ")
    del gpos, gagain, edges_t, mass, w

    # The CPU tests' size: the card against the CPU.
    rng = np.random.default_rng(SEED)
    sn, se = HALF_CPU_NODES, HALF_CPU_EDGES
    sedges = rng.integers(0, sn, (se, 2)).astype(np.int32)
    sedges[-20:] = sn
    sw = rng.integers(1, 6, se).astype(np.float32)
    smass = rng.integers(1, 400, sn).astype(np.float32)
    smass[-10:] = 0.0
    spos0 = rng.uniform(-1000, 1000, (sn, 2)).astype(np.float32)
    scfg = fa2.FA2Config(iterations=HALF_CPU_ITERATIONS, dtype="bfloat16")
    card, host = (fa2.layout(sedges, sw, smass, sn, scfg, pos0=torch.as_tensor(spos0),
                             device=dev)[0].float().cpu() for dev in ("cuda", "cpu"))
    scale = float(host.abs().max())
    out["small_vs_cpu"] = float((card - host).abs().max()) / scale
    log(f"bfloat16 layout at {sn} nodes, {HALF_CPU_ITERATIONS} iterations: card against CPU "
        f"max|Δpos| / max|pos| {out['small_vs_cpu']} (bitwise {torch.equal(card, host)})")
    check(out["small_vs_cpu"] <= HALF_CPU_TOL,
          f"bfloat16 small layout: card against CPU {out['small_vs_cpu']} > {HALF_CPU_TOL}")
    out["launches"] = {"bf16": launches, "full_bf16": full}
    log("bfloat16 phase " + json.dumps({k: v for k, v in out.items()
                                          if k not in ("positions", "launches")}))
    return out


# ------------------------------------------------------------- phase 6
def serve_phase(torch, np, cap: Capture, edges, res, cfg):
    """The tile service over the main path's result (``TilePyramid`` at
    256-px tiles, 3 levels; ``TileEngine`` with 64 MiB and 8 slots): warm
    every pyramid tile and the 8 largest drillable communities, then serve
    ``synthetic_trace(pyramid, 400, seed=0)`` twice — on the warmed engine
    (the service's steady state: every request a hit) and on a cold engine
    (every distinct tile a miss, rendered on the card) — with the counters
    set to 0 just before each and read just after. Holds the warm-up's
    pyramid tiles bitwise against direct ``render_arrays`` on the card and
    the cold trace's, one tile within ±1 of the port on the CPU, one drill's
    groups bitwise and its layout against the CPU's (positions within
    1e-4·max|pos| after 4 iterations, quality within 1 % after its 60), no
    kernel build during either trace, no failed tile, and the trace's
    launches of K3 (both entries) and, through the drills, K1, K8 and K2
    (K5–K7 too for a drilled community above 4,096 members)."""
    from repro_torch.obs.meters import jit_compile_count
    from repro_torch.obs.metrics import REGISTRY, ensure_error_counters
    from repro_torch.obs.trace import Tracer, get_tracer, set_tracer
    from repro_torch.render import render_arrays
    from repro_torch.serve import (
        DrillSpec,
        TileConfig,
        TileEngine,
        TilePyramid,
        TileRequest,
        TileSpec,
        synthetic_trace,
    )

    ensure_error_counters()
    failed0 = REGISTRY.value("errors.failed_tiles")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tcfg = TileConfig(tile_size=SERVE_TILE, depth=SERVE_DEPTH)
    pyramid = TilePyramid(res, tcfg, source=edges, bgv_cfg=cfg)
    check(pyramid.device.type == "cuda", f"pyramid on {pyramid.device}, not the result's card")
    drills = [int(c) for c in pyramid.drillable_communities()[:SERVE_DRILLS]]
    members = {c: int((res.labels == c).sum()) for c in drills}
    log(f"serve: {sum(4 ** z for z in range(SERVE_DEPTH))} pyramid tiles of {SERVE_TILE} px, "
        f"drill pool {json.dumps(members)} (community: members)")
    check(len(drills) == SERVE_DRILLS, f"{len(drills)} drillable communities")

    engine = TileEngine(pyramid, cache_bytes=SERVE_CACHE, slots=SERVE_SLOTS)
    cap.reset()
    t0 = time.perf_counter()
    warmed = engine.warmup(drills=drills)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = cap.counts()
    n_pyr = len(list(pyramid.specs()))
    check(warmed == n_pyr + SERVE_DRILLS, f"warm-up rendered {warmed} tiles")
    log(f"serve warm-up: {warmed} tiles in {warm_s} s, launches {json.dumps(warm_launches)}")

    trace = synthetic_trace(pyramid, SERVE_REQUESTS, seed=0)
    drilled = sorted({s.community for s in trace if isinstance(s, DrillSpec)})

    def serve(eng, name):
        c0 = jit_compile_count()
        hits0, miss_lat = eng.cache.hits, []
        saved = get_tracer()
        tr = set_tracer(Tracer(enabled=True))
        cap.reset()
        t0 = time.perf_counter()
        try:
            for spec in trace:
                req = TileRequest(spec)
                eng.submit(req)
                while not req.done:
                    eng.tick()
                check(not req.failed, f"{name} trace: {spec} failed")
                if not req.hit:
                    miss_lat.append(req.latency_s)
            torch.cuda.synchronize()
        finally:
            set_tracer(saved)
        dt = time.perf_counter() - t0
        spans = {}
        for sp in tr.spans():
            n, total = spans.get(sp.name, (0, 0.0))
            spans[sp.name] = (n + 1, total + sp.duration)
        out = {
            "requests": len(trace), "drills": sum(isinstance(s, DrillSpec) for s in trace),
            "seconds": dt, "tiles_per_s": len(trace) / dt,
            "hit_rate": (eng.cache.hits - hits0) / len(trace), "misses": len(miss_lat),
            "miss_p50_ms": float(np.percentile(miss_lat, 50)) * 1e3 if miss_lat else None,
            "miss_p99_ms": float(np.percentile(miss_lat, 99)) * 1e3 if miss_lat else None,
            "kernel_builds": jit_compile_count() - c0, "ticks": eng.ticks,
        }
        launches = cap.counts()
        log(f"serve {name} trace {json.dumps(out)}")
        if spans:
            log(f"serve {name} trace spans (count, seconds) {json.dumps(spans)}")
        log(f"serve {name} trace launches {json.dumps(launches)}")
        check(out["kernel_builds"] == 0, f"{name} trace built {out['kernel_builds']} kernels")
        return out, launches

    warm, _ = serve(engine, "warm")
    check(warm["misses"] == 0, "the warmed engine missed")
    cold_engine = TileEngine(pyramid, cache_bytes=SERVE_CACHE, slots=SERVE_SLOTS)
    cold, trace_launches = serve(cold_engine, "cold")
    peak = torch.cuda.max_memory_allocated()
    log(f"serve max_memory_allocated bytes {peak} ({peak - base} above the {base} "
        "bytes held before the phase)")
    check(engine.failed == cold_engine.failed == 0
          and REGISTRY.value("errors.failed_tiles") == failed0,
          f"failed tiles: {engine.failed} warm, {cold_engine.failed} cold")
    for k in ("count_scatter", "count_disks", "merge_scatter", "cms_update_keys",
              "repulsion_nbody"):
        check(trace_launches[k] > 0, f"the cold trace did not launch {k}")
    if any(members[c] > 4096 for c in drilled):
        for k in FULL_KERNELS:
            check(trace_launches[k] > 0, f"a drill above 4,096 members did not launch {k}")

    # (a) pyramid tiles bitwise against direct renders on the card, and the
    # cold trace's tiles against the warm-up's.
    radii = np.sqrt(np.maximum(res.sizes, 0.0))
    sg_edges = res.supergraph.edges.cpu().numpy()
    sg_w = res.supergraph.weights.cpu().numpy()

    def direct(spec, device):
        return render_arrays(res.positions, radii, res.groups, sg_edges, edge_weights=sg_w,
                             cfg=pyramid.render_config(spec), device=device)[0]

    for spec in pyramid.specs():
        served = engine.cache.get(spec)
        check(np.array_equal(served, direct(spec, "cuda")),
              f"served tile {spec} differs from a direct render on the card")
        again = cold_engine.cache.get(spec)
        check(again is None or np.array_equal(again, served),
              f"tile {spec} differs between the warm-up and the trace")
    # (b) one tile within ±1 of the port on the CPU.
    top = TileSpec(0, 0, 0)
    cpu_tile = direct(top, "cpu")
    diff = int(np.abs(cpu_tile.astype(np.int32) - engine.cache.get(top).astype(np.int32)).max())
    nonbg = float((cpu_tile != 255).any(axis=-1).mean())
    log(f"serve tile {top}: card against CPU max |Δ| {diff}, non-background {nonbg}")
    check(diff <= 1, f"tile {top}: card and CPU differ by {diff}")
    check(nonbg > 0.01, f"tile {top} is {nonbg:.4f} non-background")
    # A drill, card against CPU. Its groups are bitwise. Its positions are
    # held as the consistency phase holds them, within 1e-4·max|pos| after 4
    # iterations of the drill's own config: K2 rounds differently from its
    # plain version, and over the drill's 60 iterations FA2's speed
    # controller amplifies that far beyond 1e-4, so there the layout is
    # held against the CPU by its quality (neighbourhood preservation and
    # stress within 1 %), and on the card bitwise run to run.
    from repro_torch.quality import neighborhood_preservation, sampled_stress

    c = drills[0]
    t0 = time.perf_counter()
    drill = {}
    for its in (4, tcfg.drill_iterations):
        short = dataclasses.replace(tcfg, drill_iterations=its)
        drill[its] = {d: TilePyramid(res, short, source=edges, bgv_cfg=cfg,
                                     device=d).drill_layout(c) for d in ("cuda", "cpu")}
    again = TilePyramid(res, tcfg, source=edges, bgv_cfg=cfg, device="cuda").drill_layout(c)
    first = drill[tcfg.drill_iterations]["cuda"]
    bitwise = all(np.array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))
                  for x, y in zip(again, first))
    log(f"serve drill {c}, {tcfg.drill_iterations} iterations on the card: bitwise run to "
        f"run {bitwise}")
    check(bitwise, f"drill {c}: two runs on the card differ")
    for its, on in drill.items():
        (sub_g, mem_g, pos_g, grp_g), (sub_c, mem_c, pos_c, grp_c) = on["cuda"], on["cpu"]
        check(np.array_equal(sub_g, sub_c) and np.array_equal(mem_g, mem_c), "drill subgraph")
        check(np.array_equal(grp_g, grp_c), f"drill {c}, {its} iterations: groups differ cuda/cpu")
        scale = float(np.abs(pos_c).max())
        rel = np.abs(pos_g - pos_c).max(axis=1) / scale
        m = len(mem_c)
        q = {d: {"neighborhood": neighborhood_preservation(np.asarray(p, np.float64), sub_c, m),
                 "stress": sampled_stress(np.asarray(p, np.float64), sub_c, m)}
             for d, p in (("cuda", pos_g), ("cpu", pos_c))}
        log(f"serve drill {c}, {its} iterations: {m} members, {len(sub_c)} internal edges, "
            f"groups bitwise; positions max|Δ| {float(rel.max()) * scale} of {scale}, "
            f"nodes beyond 1e-4·max|pos| {int((rel > 1e-4).sum())}; quality {json.dumps(q)}")
        if its == 4:
            check(float(rel.max()) <= 1e-4,
                  f"drill {c}: positions differ cuda/cpu by {float(rel.max())}·max|pos| (> 1e-4)")
        for k in ("neighborhood", "stress"):
            a, b = q["cuda"][k], q["cpu"][k]
            check(abs(a - b) <= 1e-2 * abs(b), f"drill {c}, {its} iterations: {k} {a} vs {b}")
    log(f"serve drill checks: host seconds {time.perf_counter() - t0:.3f}")
    return {"warm_s": warm_s, "warm": warm, "cold": cold, "peak": peak,
            "warm_launches": warm_launches, "trace_launches": trace_launches}


# ------------------------------------------------------------- phase 7
def launcher_phase(np):
    """Each launcher once, on the card by default, as a subprocess at a
    small size with ``--trace-out`` and ``--metrics-out`` (the serve
    launcher also with ``--profile``): each must exit 0 and write its image,
    its span trace and its metrics dump, with the card's memory gauges in
    it. The three run at once, beside ``stream_runner`` (``stream_runner_round_trip``);
    all are waited for."""
    import os

    runs = {
        "serve": ["--nodes", "3000", "--depth", "2", "--requests", "100",
                  "--out", "serve.png", "--profile", "prof"],
        "render_runner": ["--nodes", "20000", "--communities", "200", "--iterations", "20",
                          "--out", "render.png"],
        "layout": ["--edges", "synthetic:3000:30", "--iterations", "50", "--out", "layout.svg"],
    }
    images = {"serve": "serve.png", "render_runner": "render.png", "layout": "layout.svg"}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for name, argv in runs.items():
                d = Path(tmp) / name
                d.mkdir()
                cmd = [sys.executable, "-m", f"repro_torch.launch.{name}", *argv,
                       "--trace-out", "trace.json", "--metrics-out", "metrics.txt"]
                with open(d / "out.txt", "w") as f:
                    procs[name] = (d, subprocess.Popen(cmd, cwd=d, env=env, stdout=f,
                                                       stderr=subprocess.STDOUT))
            stream_runner_round_trip(Path(tmp) / "stream_runner", env)
            for name, (d, p) in procs.items():
                t0 = time.perf_counter()
                p.wait(timeout=LAUNCHER_TIMEOUT)
                log(f"launcher {name}: exit {p.returncode}, waited {time.perf_counter() - t0:.3f} s")
        finally:
            for _, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for name, (d, p) in procs.items():
            tail = "\n".join((d / "out.txt").read_text().splitlines()[-12:])
            log(f"launcher {name} output (last lines):\n{tail}")
            check(p.returncode == 0, f"launcher {name} exited {p.returncode}")
            for f in (images[name], "trace.json", "metrics.txt"):
                check((d / f).is_file() and (d / f).stat().st_size > 0,
                      f"launcher {name} wrote no {f}")
            spans = json.loads((d / "trace.json").read_text())["traceEvents"]
            dump = (d / "metrics.txt").read_text()
            check("cuda.dev0.peak_bytes" in dump, f"launcher {name}: no card memory gauge")
            log(f"launcher {name}: {len(spans)} spans, "
                + ", ".join(ln for ln in dump.splitlines()
                            if ln.startswith(("cuda.", "render.seconds", "serve.cache_hit"))))
        prof = Path(tmp) / "serve" / "prof" / "trace.json"
        check(prof.is_file(), "the serve launcher's --profile wrote no trace")
        log("serve launcher profile: " + json.dumps(profile_busy(np, prof)))


def stream_runner_round_trip(d: Path, env):
    """``repro_torch.launch.stream_runner`` from an ``.npy`` store with a
    checkpoint every chunk, on the card: SIGTERM once the first
    ``step_*.npz`` appears, which must exit 0 with the preempted message;
    then ``--resume``, which must report its cursor, stream equal to one
    shot, and write its trace and metrics."""
    import signal

    d.mkdir()
    ckdir = d / "ckpt"
    cmd = [sys.executable, "-m", "repro_torch.launch.stream_runner", *STREAM_RUNNER_ARGS,
           "--source", "npy", "--checkpoint-dir", str(ckdir), "--checkpoint-every", "4",
           "--trace-out", "trace.json", "--metrics-out", "metrics.txt"]
    t0 = time.perf_counter()
    with open(d / "first.txt", "w") as f:
        p = subprocess.Popen(cmd, cwd=d, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        while p.poll() is None and not list(ckdir.glob("step_*.npz")):
            check(time.perf_counter() - t0 < LAUNCHER_TIMEOUT, "stream_runner wrote no checkpoint")
            time.sleep(0.01)
        signalled = p.poll() is None
        if signalled:
            p.send_signal(signal.SIGTERM)
        p.wait(timeout=LAUNCHER_TIMEOUT)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    first = (d / "first.txt").read_text()
    log(f"launcher stream_runner (SIGTERM after the first checkpoint): exit {p.returncode} "
        f"in {time.perf_counter() - t0:.3f} s; last lines:\n"
        + "\n".join(first.splitlines()[-4:]))
    check(signalled, "stream_runner ended before its first checkpoint could be signalled")
    check(p.returncode == 0 and "preempted:" in first,
          f"stream_runner did not exit 0 preempted (exit {p.returncode})")
    t0 = time.perf_counter()
    second = subprocess.run(cmd + ["--resume"], cwd=d, env=env, capture_output=True, text=True,
                            timeout=LAUNCHER_TIMEOUT)
    text = second.stdout + second.stderr
    log(f"launcher stream_runner --resume: exit {second.returncode} in "
        f"{time.perf_counter() - t0:.3f} s; last lines:\n" + "\n".join(text.splitlines()[-12:]))
    check(second.returncode == 0, f"stream_runner --resume exited {second.returncode}")
    check("resumed from checkpoint at" in text, "stream_runner --resume did not resume")
    check("streamed == one-shot: True" in text, "stream_runner --resume: streamed != one-shot")
    dump = (d / "metrics.txt").read_text()
    check((d / "trace.json").stat().st_size > 0 and "cuda.dev0.peak_bytes" in dump,
          "stream_runner --resume wrote no trace or no card memory gauge")


def profile_busy(np, path):
    """Device busy share of a ``torch.profiler`` Chrome trace: the union of
    its kernel and memcpy/memset intervals over the span from the first to
    the last event of any kind."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, -np.inf
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"device_events": len(dev), "span_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (t1 - t0) if t1 > t0 else None}


# ------------------------------------------------------------- phase 9
def bbox_pixels(torch, cx, cy, r, live, h, w) -> int:
    """Pixels in the live disks' own bounding boxes, clipped to the image:
    the pixels a disk kernel must test."""
    def span(c, lim):
        lo = torch.clamp(torch.ceil(c.double() - r.double()), min=0)
        hi = torch.clamp(torch.floor(c.double() + r.double()), max=lim - 1)
        return torch.clamp(hi - lo + 1, min=0)

    return int((span(cx, w) * span(cy, h))[live].sum())


def bytes_ops(cost) -> tuple:
    """A cost function's (operations, bytes) as ``kernel_row``'s (bytes,
    operations)."""
    return cost[1], cost[0]


def kernel_row(by_path, name, ms, plain_ms, lib_ms, err, bytes_, ops, shape,
               library=NO_LIBRARY) -> dict:
    """One row of the ``kernels`` line; ``launches`` from ``by_path`` (each
    path's measured run's counts), the bound from the run's bytes and
    operations."""
    bound_b = bytes_ / PEAK_BYTES_PER_S * 1e3
    bound_o = ops / PEAK_F32_PER_S * 1e3
    source, replaces, counter, path = KERNELS[name]
    r = {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{source}.cu", "replaces": replaces,
        "launches": by_path.get(path, {}).get(counter, 0), "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": lib_ms, "library": library, "path": path or "none",
    }
    log(f"{name} {shape}: ms {ms} plain_ms {plain_ms} library_ms {lib_ms} "
        f"({library}) bound_ms {r['bound_ms']} ({r['bound_by']}: bytes {bound_b} ms, "
        f"operations {bound_o} ms) max_abs_err {err} launches {r['launches']} ({r['path']})")
    return r


def time_kernels(torch, np, cap: Capture, main_launches, full_launches, multi_launches,
                 half_launches):
    """One row per kernel entry and path (``KERNELS``). ``launches`` is the
    entry's count from the measured run of its path: the main path for K1,
    K2, K3, K4 and K8's keys-in entry, the full path for K3 again and
    K5–K7, the multi-device phase (rank 0) for K2's and K6's row entries;
    K1's generic scatter_combine and K8's hashed entry are on no path
    (their launches are 0); the bfloat16 rows' from the half-width runs
    (``half_launches``: paths "bf16", "full_bf16", "multi_bf16"). The row
    entries are timed on the range rank 1
    of 2 owns, of the single-rank paths' recorded inputs (the same arrays
    the 2-rank run hands them). ``library_ms`` is the time of one PyTorch
    call computing the same function, or null where there is none;
    ``library`` names the call, or says there is none."""
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.kernels.merge.ref import merge_place_ref, scatter_combine_ref
    from repro_torch.kernels.raster import ops as raster_ops
    from repro_torch.kernels.raster.ref import disk_accum_into_ref, disk_accum_ref
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.repulsion.ref import repulsion_chunked, repulsion_chunked_rows

    rows = []
    by_path = {"main": main_launches, "full": full_launches, "multi": multi_launches,
               **half_launches}

    def row(*args, **kw):
        rows.append(kernel_row(by_path, *args, **kw))

    # K1 (merge_place) on the main path's last merge, and the generic
    # scatter_combine on the same rows, concatenated (outside the timed
    # span). The library yardstick runs on the kept rows only (filtered
    # outside the timed span): sending dropped rows to one scratch slot
    # would serialise the library's scatter on that slot.
    _, (pos_s, sa, sb, sw, pos_c, ca, cb, cw, capn), _ = cap.calls["merge_scatter"]
    k1 = cap.fn("merge_scatter")
    runs = (pos_s, sa, sb, sw, pos_c, ca, cb, cw, capn)
    got, want = k1(*runs), merge_place_ref(*runs)
    check(all(bits_equal(torch, g, x) for g, x in zip(got, want)),
          "K1 differs on main-path input")
    check(all(bits_equal(torch, g, x) for g, x in zip(got, k1(*runs))),
          "K1 main-path input: two launches differ")
    pos, a, b, w = (torch.cat([x, y]) for x, y in zip((pos_s, sa, sb, sw), (pos_c, ca, cb, cw)))
    keep = (pos >= 0) & (pos < capn)
    idx, a_k, b_k, w_k = pos[keep].long(), a[keep], b[keep], w[keep]
    oa = torch.full((capn,), -1, dtype=torch.int32, device=pos.device)
    ob, ow = oa.clone(), torch.zeros(capn, device=pos.device)

    def lib1():
        oa.scatter_reduce_(0, idx, a_k, "amax", include_self=True)
        ob.scatter_reduce_(0, idx, b_k, "amax", include_self=True)
        ow.index_put_((idx,), w_k, accumulate=True)

    # merge_place's bound counts the kept rows only: the ranks are sorted,
    # so the rows of rank >= cap in each run's tail are never needed. The
    # generic scatter_combine takes arbitrary positions and must read every
    # row. Both figures go into the shape text.
    nrow, kept = pos.numel(), idx.numel()
    kept_bytes, all_bytes = kept * 16 + capn * 12, nrow * 16 + capn * 12
    lib_ms = cuda_ms(torch, lib1, REPS)
    shape = (f"N={nrow} ({pos_s.numel()} state + {pos_c.numel()} chunk) kept={kept} "
             f"cap={capn}; bytes kept rows {kept_bytes} "
             f"({kept_bytes / PEAK_BYTES_PER_S * 1e3} ms), all rows {all_bytes} "
             f"({all_bytes / PEAK_BYTES_PER_S * 1e3} ms)")
    library = "scatter_reduce_ ×2 + index_put_ on the kept rows"
    row("merge_scatter",
        cuda_ms(torch, lambda: k1(*runs), REPS),
        cuda_ms(torch, lambda: merge_place_ref(*runs), REPS),
        lib_ms, 0.0, kept_bytes, nrow, shape, library)
    gen = merge_ops.scatter_combine
    check(all(bits_equal(torch, g, x) for g, x in zip(gen(pos, a, b, w, capn), want)),
          "generic scatter_combine differs on main-path input")
    row("scatter_combine",
        cuda_ms(torch, lambda: gen(pos, a, b, w, capn), REPS),
        cuda_ms(torch, lambda: scatter_combine_ref(pos, a, b, w, capn), REPS),
        lib_ms, 0.0, all_bytes, nrow, shape, library)

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
        None, err, *bytes_ops(rep_ops.repulsion_cost(n2, radii is not None)),
        f"n={n2} radii={radii is not None}")
    # K2's row entry on rank 1's half of the same input: bitwise the full
    # launch's rows. It reads every source once and writes its rows.
    i0, nl = n2 // MD_RANKS, n2 - n2 // MD_RANKS
    fr2 = rep_ops.repulsion_rows(p, m, i0, nl, kr, radii=radii)
    check(bits_equal(torch, fr2, fk[i0:i0 + nl]),
          "K2 rows on the main-path input differ from the full launch's rows")
    row("repulsion_rows",
        cuda_ms(torch, lambda: rep_ops.repulsion_rows(p, m, i0, nl, kr, radii=radii), REPS),
        cuda_ms(torch, lambda: repulsion_chunked_rows(p, m, i0, nl, kr, radii=radii), 2),
        None, float((fr2 - fr[i0:i0 + nl]).abs().max()),
        *bytes_ops(rep_ops.repulsion_rows_cost(n2, nl, radii is not None)),
        f"n={n2} rows [{i0}, {i0 + nl}) radii={radii is not None}")

    # K3's raw entry on one edge chunk of each path, its disk entry on each
    # path's node pass.
    for tag in ("", "@full"):
        time_count_scatter(torch, cap, row, tag)
        time_count_disks(torch, cap, row, tag)

    # K4, fresh (zero fill included) as the table times it, on the node
    # pass's recorded input; the accumulating form the node pass calls is
    # logged beside it. The function needs only the pixels inside each live
    # disk's bounding box (clipped to the image), so that is the operation
    # count.
    _, (acc_meta, cx, cy, r, g, ng), _ = cap.calls["disk_accum"]
    _, h, wd = acc_meta.shape
    base = torch.full((ng, h, wd), 3, dtype=torch.int32, device=cx.device)
    k4 = raster_ops.disk_accum
    got = k4(cx, cy, r, g, ng, h, wd)
    check(torch.equal(got, disk_accum_ref(cx, cy, r, g, ng, h, wd)),
          "K4 differs on main-path input")
    check(torch.equal(got, k4(cx, cy, r, g, ng, h, wd)), "K4 main-path input: two launches differ")
    check(torch.equal(cap.fn("disk_accum")(base.clone(), cx, cy, r, g, ng),
                      disk_accum_into_ref(base, cx, cy, r, g, ng)),
          "K4 accumulating form differs on main-path input")
    n4 = cx.numel()
    live = (r > 0) & (g >= 0) & (g < ng)
    pairs = bbox_pixels(torch, cx, cy, r, live, h, wd)
    into_ms = cuda_ms(torch, lambda: cap.fn("disk_accum")(base, cx, cy, r, g, ng), REPS)
    row("disk_accum",
        cuda_ms(torch, lambda: k4(cx, cy, r, g, ng, h, wd), REPS),
        cuda_ms(torch, lambda: disk_accum_ref(cx, cy, r, g, ng, h, wd), 3),
        None, 0.0, n4 * 16 + ng * h * wd * 4, K4_OPS_PER_PAIR * pairs,
        f"n={n4} live={int(live.sum())} bbox_pairs={pairs} out={ng}x{h}x{wd} "
        f"(accumulating form, no fill: {into_ms} ms)")
    time_grid_kernels(torch, np, cap, row)
    time_half_kernels(torch, np, cap, row)
    return rows


def time_half_kernels(torch, np, cap: Capture, row):
    """K2's two entries and K7's attraction on both paths, on the bfloat16
    casts of the paths' recorded inputs (``half_inputs``), beside their
    plain versions (and, for the attraction, ``index_add_`` of its
    materialised bfloat16 terms); the bounds count 2 bytes an element."""
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.repulsion.ref import repulsion_chunked, repulsion_chunked_rows
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import attraction_sum_ref

    (p, m, kr, radii), att = half_inputs(torch, np, cap, "bfloat16")
    k2 = cap.fn("repulsion_nbody")
    n, r = p.shape[0], radii is not None
    fk, fp = k2(p, m, kr, radii=radii), repulsion_chunked(p, m, kr, radii=radii)
    row("repulsion_nbody_bf16",
        cuda_ms(torch, lambda: k2(p, m, kr, radii=radii), REPS),
        cuda_ms(torch, lambda: repulsion_chunked(p, m, kr, radii=radii), 2),
        None, float((fk.float() - fp.float()).abs().max()),
        *bytes_ops(rep_ops.repulsion_cost(n, r, p.element_size())), f"n={n} radii={r} bfloat16")
    i0, nl = n // MD_RANKS, n - n // MD_RANKS
    fr = rep_ops.repulsion_rows(p, m, i0, nl, kr, radii=radii)
    row("repulsion_rows_bf16",
        cuda_ms(torch, lambda: rep_ops.repulsion_rows(p, m, i0, nl, kr, radii=radii), REPS),
        cuda_ms(torch, lambda: repulsion_chunked_rows(p, m, i0, nl, kr, radii=radii), 2),
        None, float((fr.float() - fp[i0:i0 + nl].float()).abs().max()),
        *bytes_ops(rep_ops.repulsion_rows_cost(n, nl, r, p.element_size())),
        f"n={n} rows [{i0}, {i0 + nl}) radii={r} bfloat16")
    k7 = cap.fn("attraction_sum")
    for tag, suffix in (("", ""), ("@full", "_full")):
        pos, dst, w, lay = att[tag]
        got = k7(pos, dst, w, lay)
        cpu = attraction_sum_ref(pos.cpu(), dst.cpu(), w.cpu(), lay.offsets.cpu())
        _, terms, src = attraction_old(torch, pos, dst, w, lay.offsets)
        idx = src.long()
        out = torch.zeros((pos.shape[0], 2), dtype=pos.dtype, device=pos.device)
        row(f"attraction_sum{suffix}_bf16",
            cuda_ms(torch, lambda: k7(pos, dst, w, lay), REPS),
            cuda_ms(torch, lambda: attraction_sum_ref(pos, dst, w, lay.offsets), REPS),
            cuda_ms(torch, lambda: out.index_add_(0, idx, terms), REPS),
            float((got.cpu().float() - cpu.float()).abs().max()),
            *bytes_ops(seg_ops.attraction_sum_cost(pos.shape[0], terms.shape[0],
                                                   pos.element_size())),
            f"E={dst.shape[0]} rows, {terms.shape[0]} kept, N={pos.shape[0]} bfloat16",
            "index_add_ of the materialised kept terms (bfloat16)")


def time_count_scatter(torch, cap: Capture, row, tag: str):
    """K3's raw entry on the recorded edge chunk of the main path (tag "")
    or the full path ("@full"). The library yardstick runs on the kept rows
    only, as for K1."""
    from repro_torch.kernels.raster.ref import count_scatter_into_ref

    _, (acc0, pos3, inc3), _ = cap.calls["count_scatter" + tag]
    k3 = cap.fn("count_scatter")
    got = k3(acc0.clone(), pos3, inc3)
    check(torch.equal(got, count_scatter_into_ref(acc0.clone(), pos3, inc3)),
          f"K3 differs on the recorded edge chunk{tag}")
    check(torch.equal(got, k3(acc0.clone(), pos3, inc3)),
          f"K3 recorded edge chunk{tag}: two launches differ")
    size = acc0.numel()
    keep = (pos3 >= 0) & (pos3 < size)
    hit = int(torch.unique(pos3[keep]).numel())
    acc_k, acc_p, acc_l = acc0.clone(), acc0.clone(), acc0.clone()
    idx3 = pos3[keep].long()
    inc_l = inc3[keep] if inc3 is not None else torch.ones_like(idx3, dtype=torch.int32)
    row("count_scatter" + ("_full" if tag else ""),
        cuda_ms(torch, lambda: k3(acc_k, pos3, inc3), REPS),
        cuda_ms(torch, lambda: count_scatter_into_ref(acc_p, pos3, inc3), REPS),
        cuda_ms(torch, lambda: acc_l.index_put_((idx3,), inc_l, accumulate=True), REPS),
        0.0, pos3.numel() * (8 if inc3 is not None else 4) + hit * 8, pos3.numel(),
        f"N={pos3.numel()} kept={idx3.numel()} size={size} distinct_hits={hit} "
        f"inc={inc3 is not None}", "index_put_ (accumulate) on the kept rows")


def time_count_disks(torch, cap: Capture, row, tag: str):
    """K3's small-disk entry on the recorded node pass of the main path
    (tag "") or the full path ("@full"), into a nonzero base. Bytes: 16 a
    disk and each covered pixel read and written once; operations: 6 per
    pixel of each live disk's own bounding box, clipped to the image, as
    for K4."""
    from repro_torch.kernels.raster.ref import count_disks_into_ref

    _, (acc_meta, px, py, r, g, ng), _ = cap.calls["count_disks" + tag]
    base = torch.full(acc_meta.shape, 3, dtype=torch.int32, device=px.device)
    k3 = cap.fn("count_disks")
    got = k3(base.clone(), px, py, r, g, ng)
    check(torch.equal(got, count_disks_into_ref(base.clone(), px, py, r, g, ng)),
          f"K3 disks differ on the recorded node pass{tag}")
    check(torch.equal(got, k3(base.clone(), px, py, r, g, ng)),
          f"K3 recorded node pass{tag}: two launches differ")
    covered = int((got != base).sum())
    del got
    _, hs, ws = acc_meta.shape
    live = (r > 0) & (g >= 0) & (g < ng)
    pairs = bbox_pixels(torch, px, py, r, live, hs, ws)
    m = px.numel()
    acc_k, acc_p = base.clone(), base.clone()
    row("count_disks" + ("_full" if tag else ""),
        cuda_ms(torch, lambda: k3(acc_k, px, py, r, g, ng), REPS),
        cuda_ms(torch, lambda: count_disks_into_ref(acc_p, px, py, r, g, ng), 3),
        None, 0.0, m * 16 + covered * 8, K4_OPS_PER_PAIR * pairs,
        f"disks={m} live={int(live.sum())} bbox_pixels={pairs} covered_pixels={covered} "
        f"out={ng}x{hs}x{ws}")


def time_grid_kernels(torch, np, cap: Capture, row):
    """K5–K7 on the full path's recorded inputs (the converged layout), K8
    on the main path's one CMS update."""
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.cms.ref import cms_update_ref
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.kernels.grid.ref import far_field_ref, near_field_ref
    from repro_torch.kernels.grid.ref import near_field_rows as near_field_rows_ref

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
        None, err, *bytes_ops(grid_ops.far_field_cost(n, c)),
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
    pairs = sum(2 * int((cell_s[k:] == cell_s[:-k]).sum()) for k in range(1, w_eff + 1))
    cost = grid_ops.near_field_cost(n, w, pairs)
    slots = cost[0] - grid_ops.NEAR_OPS_PER_PAIR * pairs
    row("near_field",
        cuda_ms(torch, lambda: k6(pos_s, mass_s, cell_s, kr, w), REPS),
        cuda_ms(torch, lambda: near_field_ref(pos_s, mass_s, cell_s, kr, w), 3),
        None, 0.0, *bytes_ops(cost),
        f"n={n} W={w} band_slots={slots} same_cell_pairs={pairs}")
    # K6's row entry on rank 1's half of the same input. It needs its rows
    # and their ±W band (16 bytes each), and writes its rows; slots and
    # same-cell pairs are those of its rows.
    i0, nl = n // MD_RANKS, n - n // MD_RANKS
    full6 = k6(pos_s, mass_s, cell_s, kr, w)
    got6 = grid_ops.near_field_rows(pos_s, mass_s, cell_s, kr, w, i0, nl)
    check(bits_equal(torch, got6, full6[i0:i0 + nl]),
          "K6 rows on the full-path input differ from the full launch's rows")
    check(bits_equal(torch, got6, near_field_rows_ref(pos_s, mass_s, cell_s, kr, w, i0, nl)),
          "K6 rows differ from the plain row form on the full-path input")
    idx = torch.arange(i0, i0 + nl, device=pos_s.device)
    rpairs = 0
    for k in range(-w_eff, w_eff + 1):
        if k == 0:
            continue
        j = idx + k
        ok = (j >= 0) & (j < n)
        rpairs += int((ok & (cell_s[j.clamp(0, n - 1)] == cell_s[idx])).sum())
    cost = grid_ops.near_field_rows_cost(n, w, i0, nl, rpairs)
    rslots = cost[0] - grid_ops.NEAR_OPS_PER_PAIR * rpairs
    row("near_field_rows",
        cuda_ms(torch, lambda: grid_ops.near_field_rows(pos_s, mass_s, cell_s, kr, w, i0, nl),
                REPS),
        cuda_ms(torch, lambda: near_field_rows_ref(pos_s, mass_s, cell_s, kr, w, i0, nl), 3),
        None, 0.0, *bytes_ops(cost),
        f"n={n} rows [{i0}, {i0 + nl}) W={w} band_slots={rslots} same_cell_pairs={rpairs}")

    # K7: the cell statistics (full path), and on both paths the
    # attraction's layout build and its fused sum.
    time_k7(torch, cap, row, "segment_sum", "segment_sum")
    for tag, suffix in (("", ""), ("@full", "_full")):
        time_offsets(torch, cap, row, tag, "segment_offsets" + suffix)
        time_attraction(torch, cap, row, tag, "attraction_sum" + suffix)

    # K8 on the main path's CMS input. The hashed entry (the TPU kernel's
    # contract) with the keys hashed once, outside the timed span; its
    # library yardstick is index_put_ (accumulate) on the kept slots. The
    # keys-in entry, which the pipeline's core.cms.update launches, against
    # its plain version (the torch hash + index_put_); its bound reads each
    # key and weight once.
    _, (sketch, keys, weights, cfg), _ = cap.calls["cms_update"]
    h = cms_ops.hashed_buckets(keys, cfg)
    wv = weights.to(torch.float32).contiguous()
    got = cms_ops.update_hashed(sketch, h, wv)
    check(bits_equal(torch, got, cms_update_ref(sketch, h, wv)), "K8 differs on main-path input")
    check(bits_equal(torch, got, cms_ops.update_hashed(sketch, h, wv)),
          "K8 main-path input: two launches differ")
    check(bits_equal(torch, cap.fn("cms_update")(sketch, keys, weights, cfg), got),
          "K8 keys-in entry differs from the hashed entry on main-path input")
    rows8, n8 = h.shape
    kept = h >= 0
    r8 = torch.arange(rows8, device=h.device)[:, None].expand_as(h)[kept]
    b8, w8 = h[kept].long(), wv[None, :].expand_as(h)[kept]
    lib8 = sketch.clone()
    shape = f"rows={rows8} cols={sketch.shape[1]} n={n8} kept={int(kept.sum())}"
    row("cms_update",
        cuda_ms(torch, lambda: cms_ops.update_hashed(sketch, h, wv), REPS),
        cuda_ms(torch, lambda: cms_update_ref(sketch, h, wv), REPS),
        cuda_ms(torch, lambda: lib8.index_put_((r8, b8), w8, accumulate=True), REPS),
        0.0, *bytes_ops(cms_ops.update_hashed_cost(n8, rows8, sketch.shape[1], int(kept.sum()))),
        shape,
        "index_put_ (accumulate) on the kept slots")
    k8 = cap.fn("cms_update")
    row("cms_update_keys",
        cuda_ms(torch, lambda: k8(sketch, keys, weights, cfg), REPS),
        cuda_ms(torch, lambda: cms_update_ref(sketch, cms_ops.hashed_buckets(keys, cfg), wv),
                REPS),
        None, 0.0, *bytes_ops(cms_ops.update_cost(n8, rows8, sketch.shape[1], int(kept.sum()))),
        shape)


def time_k7(torch, cap: Capture, row, key: str, name: str):
    """K7 on one recorded input: bitwise against its plain version on the
    CPU and run to run, within its bound of the card's plain version. The
    library yardstick is index_add_ on the kept rows (filtered outside the
    timed span)."""
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import segment_sum_ref

    _, (data, seg, n_seg), kw = cap.calls[key]
    k7 = cap.fn(key.split("@")[0])
    worst = k7_check(torch, key, data, seg, n_seg, kw.get("indices_are_sorted", False))
    keep = (seg >= 0) & (seg < n_seg)
    idx7, data7 = seg[keep].long(), data[keep]
    out7 = torch.zeros((n_seg,) + tuple(data.shape[1:]), device=data.device)
    largest = int(torch.bincount(idx7, minlength=n_seg).max())
    log(f"K7 {key} worst |Δ| / 2γ(k−1)Σ|x| {worst}; largest segment {largest} rows")
    e, d = data.shape[0], data.shape[1]
    row(name,
        cuda_ms(torch, lambda: k7(data, seg, n_seg, **kw), REPS),
        cuda_ms(torch, lambda: segment_sum_ref(data, seg, n_seg), REPS),
        cuda_ms(torch, lambda: out7.index_add_(0, idx7, data7), REPS),
        0.0, *bytes_ops(seg_ops.segment_sum_cost(e, d, n_seg)),
        f"E={e} D={d} N={n_seg} sorted={kw.get('indices_are_sorted', False)} "
        f"largest_segment={largest}",
        "index_add_ on the kept rows")



def time_offsets(torch, cap: Capture, row, tag: str, name: str):
    """K7's layout build on one path's recorded input (the attraction's
    sorted sources): the layout bitwise its plain version on the CPU and
    run to run; the offsets entry timed beside its plain version and
    ``searchsorted`` (one PyTorch call that computes the offsets from the
    sorted ids), the whole build (the groups included) logged."""
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import segment_layout_ref, segment_offsets_ref

    _, (ids, n), kw = cap.calls["segment_offsets" + tag]
    build_fn = cap.fn("segment_offsets")
    lay = build_fn(ids, n, **kw)
    again = build_fn(ids, n, **kw)
    check(bits_equal(torch, lay.offsets, again.offsets)
          and bits_equal(torch, lay.groups, again.groups)
          and (lay.perm is None or bits_equal(torch, lay.perm, again.perm)),
          f"K7 {name}: two layout builds differ")
    perm_c, off_c = segment_layout_ref(ids.cpu(), n, **kw)
    check(bits_equal(torch, lay.offsets.cpu(), off_c)
          and (perm_c is None or bits_equal(torch, lay.perm.cpu(), perm_c)),
          f"K7 {name}: differs from the plain version on the CPU")
    check(bits_equal(torch, lay.groups.cpu(), seg_ops.segment_groups(off_c, ids.shape[0])),
          f"K7 {name}: the groups differ from the CPU's")
    e = ids.shape[0]
    sid = ids if kw.get("sorted") else ids[lay.perm.long()]
    marks = torch.arange(n + 1, dtype=torch.int32, device=ids.device)
    build_ms = cuda_ms(torch, lambda: build_fn(ids, n, **kw), REPS)
    row(name,
        cuda_ms(torch, lambda: seg_ops.segment_offsets(sid, n), REPS),
        cuda_ms(torch, lambda: segment_offsets_ref(sid, n), REPS),
        cuda_ms(torch, lambda: torch.searchsorted(sid, marks), REPS),
        0.0, *bytes_ops(seg_ops.segment_offsets_cost(e, n)),
        f"E={e} N={n} sorted={kw.get('sorted', False)}; the whole layout build {build_ms} ms",
        "searchsorted of every segment id in the sorted ids")


def time_attraction(torch, cap: Capture, row, tag: str, name: str):
    """K7's fused attraction on one path's recorded input: bitwise its
    plain version on the CPU, the pre-change composition on the card
    (``attraction_old``) and run to run; timed beside that composition (the
    earlier time), the plain version and ``index_add_`` of the materialised
    kept terms (materialised outside the timed span)."""
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import attraction_sum_ref

    _, (pos, dst, w, lay), _ = cap.calls["attraction_sum" + tag]
    offsets = lay.offsets
    k = cap.fn("attraction_sum")
    got = k(pos, dst, w, lay)
    check(bits_equal(torch, got, k(pos, dst, w, lay)), f"K7 {name}: two launches differ")
    cpu = attraction_sum_ref(pos.cpu(), dst.cpu(), w.cpu(), offsets.cpu())
    check(bits_equal(torch, got.cpu(), cpu),
          f"K7 {name}: differs from the plain version on the CPU")
    old, terms, src = attraction_old(torch, pos, dst, w, offsets)
    check(bits_equal(torch, got, old()), f"K7 {name}: differs from the pre-change composition")
    n, e = pos.shape[0], dst.shape[0]
    kept = terms.shape[0]
    idx = src.long()
    out = torch.zeros((n, 2), device=pos.device)
    largest = int(torch.diff(offsets).max()) if n else 0
    old_ms = cuda_ms(torch, old, REPS)
    log(f"K7 {name}: the pre-change composition (terms materialised, the warp-per-segment "
        f"kernel) {old_ms} ms")
    row(name,
        cuda_ms(torch, lambda: k(pos, dst, w, lay), REPS),
        cuda_ms(torch, lambda: attraction_sum_ref(pos, dst, w, offsets), REPS),
        cuda_ms(torch, lambda: out.index_add_(0, idx, terms), REPS),
        0.0, *bytes_ops(seg_ops.attraction_sum_cost(n, kept)),
        f"E={e} rows, {kept} kept, N={n} largest_segment={largest}; pre-change composition "
        f"{old_ms} ms", "index_add_ of the materialised kept terms")


# ------------------------------------------------------------- phase 10
def full_node_consistency(torch, np, recorded):
    """The full path's node pass (its recorded small disks, through the
    renderer's ``_node_pass``) against the plain version on the card, which
    materialises every disk's box: 685,230 × 324 rows, ≈ 5 GB."""
    from repro_torch.kernels.raster.ref import count_disks_into_ref
    from repro_torch.render import raster

    acc_meta, px, py, r, g, ng = recorded
    _, hs, ws = acc_meta.shape
    got = raster._node_pass(*(x.cpu().numpy() for x in (px, py, r, g)), ng, hs, ws,
                            torch.device("cuda"))
    want = count_disks_into_ref(torch.zeros_like(got), px, py, r, g, ng)
    check(torch.equal(got, want), "full-path node accumulator differs from the plain version")
    log(f"full-path node accumulator: {px.numel()} disks, {int(got.sum())} pixel counts, "
        "bitwise against the plain version on the card")
    del got, want
    torch.cuda.empty_cache()


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


# ------------------------------------------------------------- phase 8
def md_rank(mesh, npy: str, out_dir: str, delta: int) -> None:
    """One rank of the multi-device phase, a process of its own (spawned by
    ``multi_device_phase``): the main path with the edge passes and the
    supergraph layout spread over the ranks, then the full graph's grid
    force pass. Writes ``out_dir/rank{r}.npz`` and ``.json``."""
    import os

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import cms as cms_lib
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.core.pipeline import layout_supergraph
    from repro_torch.device import host_array
    from repro_torch.kernels import build
    from repro_torch.render import raster
    from repro_torch.resilience import StreamCheckpointer, latest_step, load_arrays

    dev, n = mesh.device, NODES
    edges_np = np.load(npy)
    cfg = repro_torch.default_config(n, len(edges_np), delta, iterations=ITERATIONS)
    scfg = repro_torch.StreamConfig(chunk_size=MAIN_CHUNK, mesh=mesh, shard_detect=True,
                                    shard_layout=True)
    ckdir = os.path.join(out_dir, "ckpt")
    ck = StreamCheckpointer(ckdir, every_chunks=0)
    info = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    arrays = {}

    def zero():
        for k in build.LAUNCHES:
            build.LAUNCHES[k] = 0

    # 1. The main path, counters set to 0 just before and read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    t0 = time.perf_counter()
    res = repro_torch.biggraphvis(npy, n, cfg, scfg, checkpoint=ck)
    if mesh.rank == 0:
        image, rstats = res.render(os.path.join(out_dir, "md.png"))
        frac, counts = raster.image_summary(image)
        info["image"] = {"non_background": frac, "colors": int((counts > 0).sum()),
                         "render_s": res.timings["render_s"]}
    torch.cuda.synchronize()
    info["wall_s"] = time.perf_counter() - t0
    info["launches"] = dict(build.LAUNCHES)
    info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    info["timings"] = res.timings
    st = res.stream
    info["stream"] = {"devices": st.devices, "peak_local_bytes": st.peak_local_bytes,
                      "peak_device_bytes": st.peak_device_bytes, "chunks": st.chunks,
                      "saves": ck.saves}
    sg = res.supergraph
    arrays.update(labels=res.labels, positions=res.positions, sizes=res.sizes,
                  sg_edges=sg.edges.cpu().numpy(), sg_weights=sg.weights.cpu().numpy(),
                  counts=np.array([res.n_supernodes, res.n_superedges]),
                  q=np.float64(res.modularity))
    # The CMS sketch, through the sharded update the main path's sizing
    # calls, on the graph degrees the run checkpointed (every rank reads
    # rank 0's file once the save's barrier has passed).
    final, _ = load_arrays(ckdir, latest_step(ckdir))
    gdeg = torch.as_tensor(final["deg"], device=dev)
    sketch = cms_lib.sharded_update(cms_lib.init(cfg.cms, device=dev),
                                    sg.labels.to(dev), gdeg.to(torch.float32), cfg.cms, mesh)
    arrays["sketch"] = sketch.cpu().numpy()

    # 2. The grid force pass on the full graph: the first iteration's
    # gathered forces (with and without the attraction), then
    # MD_GRID_ITERATIONS iterations.
    lcfg = fa2.FA2Config(iterations=MD_GRID_ITERATIONS, repulsion="grid", grid_size=GRID,
                         grid_window=WINDOW, use_radii=False)
    pos0 = fa2.init_positions(n, lcfg.seed, device=dev)
    edges = torch.as_tensor(edges_np, device=dev)
    w = torch.ones(edges.shape[0], device=dev)
    mass = gdeg.to(torch.float32) + 1.0
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, p, radii, (dst, w2, lay) = fa2._layout_inputs(edges, w, mass, n, lcfg, pos0, dev)
    arrays["forces"] = fa2.force_pass(m, radii, dst, w2, lay, n, lcfg, mesh)(p, 0).cpu().numpy()
    arrays["forces_no_attraction"] = fa2.force_pass(
        m, radii, dst, torch.zeros_like(w2), lay, n, lcfg, mesh)(p, 0).cpu().numpy()
    pos, _, iters = fa2.layout_sharded(edges, w, mass, n, lcfg, mesh, pos0=pos0)
    torch.cuda.synchronize()
    info["grid_s"] = time.perf_counter() - t0
    info["grid_launches"] = dict(build.LAUNCHES)
    info["grid_iterations"] = iters
    arrays["grid_positions"] = pos.cpu().numpy()

    # 3. The supergraph laid out in bfloat16, node-partitioned (K2's row
    # entry and K7's attraction in bfloat16).
    hcfg = dataclasses.replace(cfg, layout=dataclasses.replace(cfg.layout, dtype="bfloat16"))
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hpos, hits = layout_supergraph(sg, hcfg, device=dev, mesh=mesh, shard_layout=True)
    torch.cuda.synchronize()
    info["bf16_s"] = time.perf_counter() - t0
    info["bf16_launches"] = dict(build.LAUNCHES)
    info["bf16_iterations"] = hits
    arrays["bf16_positions"] = host_array(hpos)
    np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(info, f)


def md_resume_rank(mesh, ckdir: str, kill_at: int) -> None:
    """One of MD_RUNNER_RANKS ranks streaming the stream launcher's graph
    with a checkpoint every MD_SAVE_EVERY chunks, killed at boundary
    ``kill_at``."""
    from repro_torch.resilience import KillSwitch, SimulatedPreemption, StreamCheckpointer

    ck = StreamCheckpointer(ckdir, every_chunks=MD_SAVE_EVERY,
                            on_boundary=KillSwitch(kill_at))
    try:
        md_runner_pipeline(mesh, checkpoint=ck)
    except SimulatedPreemption:
        return
    raise RuntimeError(f"rank {mesh.rank} was not killed at boundary {kill_at}")


def md_runner_pipeline(mesh=None, **kw):
    """``stream_pipeline`` on the stream launcher's graph and chunking
    (``STREAM_RUNNER_ARGS``), sharded over ``mesh`` when one is given."""
    import repro_torch
    from repro_torch.graph.generators import planted_partition
    from repro_torch.graph.utils import mode_degree

    n = 20000
    edges, _ = planted_partition(n, 200, 0.12, 2e-4, seed=5)
    cfg = repro_torch.default_config(n, len(edges), mode_degree(edges, n))
    scoda = dataclasses.replace(cfg.scoda, block_size=1024)
    scfg = repro_torch.StreamConfig(chunk_size=1024, mesh=mesh, shard_detect=mesh is not None)
    return repro_torch.stream_pipeline(edges, n, scoda, cfg.cms, cfg.s_cap,
                                       cfg.max_super_edges, scfg,
                                       device=None if mesh is not None else "cuda", **kw)


def multi_device_phase(torch, np, edges, res, cfg, smi: str, half_positions) -> tuple:
    """The multi-device paths on one card, D ranks under gloo.

    1. ``biggraphvis`` + ``render`` (rank 0) on phase 4's graph and config
       with ``StreamConfig(mesh, shard_detect=True, shard_layout=True)`` on
       MD_RANKS ranks, streamed from an ``.npy`` store (each rank reads its
       own rows of every chunk) with a round-boundary checkpointer, whose
       files give back the SCoDA and graph degrees: every rank bitwise
       phase 4 on labels, degrees, graph degrees, supergraph, sizes, the
       CMS sketch and Q, positions within 1e-4·max|pos|, ``devices`` = D,
       K1, K2's row entry and K8 launched on every rank, K3 (and K4 where
       phase 4 launched it) on rank 0.
    2. The grid force pass on the full graph (grid 64, window 32, 20
       iterations from a seeded start): the first iteration's gathered
       forces, with and without the attraction, and the positions after
       the 20 iterations bitwise the single-rank pass's, and two
       single-rank runs bitwise; K5, K6's row entry and K7 (the cell
       statistics, the layout build and the fused attraction)
       launched on every rank.
    3. ``stream_runner --shard all --backend gloo`` under
       ``torch.distributed.run`` on MD_RUNNER_RANKS ranks: exit 0,
       ``streamed == one-shot: True``.
    4. MD_RUNNER_RANKS ranks stream the stream launcher's graph with a
       checkpoint every chunk and are killed mid-round; one rank resumes
       from their checkpoint, bitwise an uninterrupted one-rank run.
    5. (In the ranks' run, after 2.) The supergraph laid out in bfloat16 on
       the ranks (``layout_supergraph(..., shard_layout=True)``): K2's row
       entry and the attraction launched once an iteration on every rank,
       the whole K2 never; positions within 2⁻⁷·max|pos| of the one-rank
       bfloat16 layout (``half_positions``, phase 5b).

    Returns rank 0's launches (the ``kernels`` line's counts for the row
    entries) and those of its bfloat16 layout."""
    import os

    from repro_torch.core import cms as cms_lib
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.core.scoda import detect_communities
    from repro_torch.data.edge_store import write_npy
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.resilience import StreamCheckpointer, load_arrays

    n, d = NODES, MD_RANKS
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        npy = str(write_npy(tmp / "edges.npy", edges))
        t0 = time.perf_counter()
        spawn_local(md_rank, d, backend="gloo", init_file=str(tmp / "store"),
                    args=(npy, str(tmp), cfg.scoda.degree_threshold), timeout=MD_TIMEOUT)
        out["spawn_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(d):
            with np.load(tmp / f"rank{r}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            info = json.loads((tmp / f"rank{r}.json").read_text())
            ranks.append((arrays, info))
        ckdir = tmp / "ckpt"
        steps = sorted(int(f.name[5:13]) for f in ckdir.glob("step_*.npz"))
        final, meta = load_arrays(str(ckdir), steps[-1])
        detect, dmeta = load_arrays(str(ckdir), steps[-2])
    check(meta["phase"] == "supergraph" and dmeta["phase"] == "detect"
          and dmeta["round"] == cfg.scoda.rounds,
          f"checkpoints {meta} / {dmeta}: not the end of detect and of the pass")

    # Single-rank references on the card: phase 4's result, the SCoDA
    # degrees of a one-shot detect, graph degrees counted on the host, the
    # CMS sketch of phase 4's labels.
    dev = torch.device("cuda")
    gdeg = np.bincount(edges.reshape(-1), minlength=n).astype(np.int32)
    e_dev = torch.as_tensor(edges, device=dev)
    labels1, sdeg1 = detect_communities(e_dev, n, cfg.scoda)
    sketch1 = cms_lib.update(cms_lib.init(cfg.cms, device=dev),
                             torch.as_tensor(res.labels, device=dev),
                             torch.as_tensor(gdeg, device=dev).to(torch.float32), cfg.cms)
    check(np.array_equal(detect["gdeg"][:n], gdeg) and np.array_equal(final["deg"], gdeg),
          "multi-device: graph degrees differ from a host count")
    check(np.array_equal(detect["deg"][:n], sdeg1.cpu().numpy()),
          "multi-device: SCoDA degrees differ from the single-rank detect")
    check(np.array_equal(final["labels"], labels1.cpu().numpy()),
          "multi-device: SCoDA labels differ from the single-rank detect")
    scale = float(np.abs(res.positions).max())
    sg = res.supergraph
    for r, (a, info) in enumerate(ranks):
        for k, want in (("labels", res.labels), ("sizes", res.sizes),
                        ("sg_edges", sg.edges.numpy()), ("sg_weights", sg.weights.numpy()),
                        ("counts", np.array([res.n_supernodes, res.n_superedges])),
                        ("q", np.float64(res.modularity)),
                        ("sketch", sketch1.cpu().numpy())):
            check(np.array_equal(np.atleast_1d(a[k]).view(np.uint8),
                                 np.atleast_1d(np.asarray(want, a[k].dtype)).view(np.uint8)),
                  f"multi-device rank {r}: {k} differs from the single-rank run")
        perr = float(np.abs(a["positions"] - res.positions).max())
        info["positions_max_abs_diff"] = perr
        check(perr <= 1e-4 * scale, f"multi-device rank {r}: positions differ by {perr} "
              f"(> 1e-4·{scale})")
        check(info["stream"]["devices"] == d, f"rank {r}: StreamStats.devices "
              f"{info['stream']['devices']}, expected {d}")
        la = info["launches"]
        for k in ("merge_scatter", "repulsion_rows"):
            check(la[k] > 0, f"multi-device rank {r}: {k} was not launched")
        check(la["cms_update_keys"] == 1, f"multi-device rank {r}: K8 launched "
              f"{la['cms_update_keys']} times")
        check(la["repulsion_nbody"] == 0, f"multi-device rank {r}: the full K2 launched")
        log(f"multi-device rank {r}: launches K1 {la['merge_scatter']}, K2 rows "
            f"{la['repulsion_rows']}, K8 {la['cms_update_keys']}; K3 {la['count_scatter']} "
            f"+ {la['count_disks']}, K4 {la['disk_accum']}")
        ga = info["grid_launches"]
        for k in ("far_field", "near_field_rows", "segment_sum", "segment_offsets",
                  "attraction_sum"):
            check(ga[k] > 0, f"multi-device rank {r}: {k} was not launched in the grid pass")
        check(ga["near_field"] == 0, f"multi-device rank {r}: the full K6 launched")
    lead = ranks[0][1]
    check(lead["launches"]["count_scatter"] > 0 and lead["launches"]["count_disks"] > 0,
          "multi-device: rank 0's render launched no K3")
    check(lead["image"]["non_background"] >= 0.01 and lead["image"]["colors"] >= 3,
          f"multi-device: rank 0's image {lead['image']}")
    for r, (a, _) in enumerate(ranks[1:], 1):
        for k in a:
            check(np.array_equal(np.atleast_1d(a[k]).view(np.uint8),
                                 np.atleast_1d(ranks[0][0][k]).view(np.uint8)),
                  f"multi-device: rank {r}'s {k} differs from rank 0's")
    out["ranks"] = [info for _, info in ranks]
    log("multi-device main path " + json.dumps(out["ranks"], default=str))
    md_half_checks(np, ranks, half_positions)

    # The grid force pass, single-rank, on the same inputs.
    lcfg = fa2.FA2Config(iterations=MD_GRID_ITERATIONS, repulsion="grid", grid_size=GRID,
                         grid_window=WINDOW, use_radii=False)
    pos0 = fa2.init_positions(n, lcfg.seed, device=dev)
    w = torch.ones(e_dev.shape[0], device=dev)
    mass = torch.as_tensor(gdeg, device=dev).to(torch.float32) + 1.0
    m, p, radii, (dst, w2, lay) = fa2._layout_inputs(e_dev, w, mass, n, lcfg, pos0, dev)
    f1 = fa2.force_pass(m, radii, dst, w2, lay, n, lcfg)(p, 0).cpu().numpy()
    f0 = fa2.force_pass(m, radii, dst, torch.zeros_like(w2), lay, n, lcfg)(p, 0).cpu().numpy()
    pos1, _, _ = fa2.layout(e_dev, w, mass, n, lcfg, pos0=pos0, device=dev)
    pos1 = pos1.cpu().numpy()
    again, _, _ = fa2.layout(e_dev, w, mass, n, lcfg, pos0=pos0, device=dev)
    drift1 = float(np.abs(again.cpu().numpy() - pos1).max())
    a = ranks[0][0]
    check(np.array_equal(a["forces_no_attraction"].view(np.uint8), f0.view(np.uint8)),
          "multi-device grid pass: gravity + repulsion differ from the single-rank pass")
    ferr = np.abs(a["forces"] - f1).max(1) / np.maximum(np.abs(f1).max(1), 1e-30)
    gscale = float(np.abs(pos1).max())
    gerr = float(np.abs(a["grid_positions"] - pos1).max())
    out["grid"] = {"forces_bitwise": bool(np.array_equal(a["forces"].view(np.uint8),
                                                         f1.view(np.uint8))),
                   "forces_worst_rel": float(ferr.max()), "positions_max_abs_diff": gerr,
                   "single_rank_run_to_run": drift1,
                   "max_abs_pos": gscale, "iterations": lead["grid_iterations"],
                   "seconds": [info["grid_s"] for _, info in ranks]}
    log("multi-device grid pass " + json.dumps(out["grid"]))
    check(out["grid"]["forces_bitwise"],
          f"multi-device grid pass: forces differ by {ferr.max()} of a row's |f|")
    check(drift1 == 0.0 and not np.isnan(again.cpu().numpy()).any(),
          f"grid layout: two single-rank runs differ by {drift1}")
    check(np.array_equal(a["grid_positions"].view(np.uint8), pos1.view(np.uint8)),
          f"multi-device grid pass: positions differ by {gerr} of {gscale}")
    del e_dev, dst, w2, lay, m, p
    torch.cuda.empty_cache()
    log(f"multi-device: {d} ranks under gloo on one card; wall {lead['wall_s']} s "
        f"(phase 4: {res.timings}); scoda_s {lead['timings']['scoda_s']}, supergraph_s "
        f"{lead['timings']['supergraph_s']}, layout_s {lead['timings']['layout_s']}; "
        f"peak_local_bytes {lead['stream']['peak_local_bytes']} of peak_device_bytes "
        f"{lead['stream']['peak_device_bytes']}; spawn to results {out['spawn_s']} s")

    # 3. stream_runner on MD_RUNNER_RANKS ranks under torch.distributed.run.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(MD_RUNNER_RANKS), "-m",
               "repro_torch.launch.stream_runner", *MD_RUNNER_ARGS]
        run = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                             timeout=MD_TIMEOUT)
        out["runner_s"] = time.perf_counter() - t0
    text = run.stdout + run.stderr
    log(f"multi-device stream_runner ({' '.join(cmd[2:])}): exit {run.returncode} in "
        f"{out['runner_s']:.3f} s; last lines:\n" + "\n".join(run.stdout.splitlines()[-10:]))
    check(run.returncode == 0, f"stream_runner on {MD_RUNNER_RANKS} ranks exited "
          f"{run.returncode}:\n" + "\n".join(text.splitlines()[-30:]))
    check("streamed == one-shot: True" in run.stdout,
          f"stream_runner on {MD_RUNNER_RANKS} ranks: streamed != one-shot")

    # 4. A checkpoint written by MD_RUNNER_RANKS ranks, resumed on one: the
    # kill lands mid-round 1, on a boundary that saves first.
    want = md_runner_pipeline()
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = str(Path(tmp) / "ckpt")
        n_chunks = -(-int(want[4].edges_streamed // want[4].passes) // 1024)
        kill_at = (n_chunks + n_chunks // 2) // MD_SAVE_EVERY * MD_SAVE_EVERY - 1
        t0 = time.perf_counter()
        spawn_local(md_resume_rank, MD_RUNNER_RANKS, backend="gloo",
                    init_file=str(Path(tmp) / "store"), args=(ckdir, kill_at),
                    timeout=MD_TIMEOUT)
        killed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = md_runner_pipeline(checkpoint=StreamCheckpointer(ckdir), resume=True)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
    out["resume"] = {"killed_at_boundary": kill_at, "resumed_at": got[4].resumed_at,
                     "ranks_s": killed_s, "resumed_s": resumed_s}
    log("multi-device resume across rank counts " + json.dumps(out["resume"]))
    check(got[4].resumed_at == f"detect:r1:c{kill_at - n_chunks + 1}",
          f"resumed at {got[4].resumed_at}")
    for i, what in ((0, "labels"), (1, "graph degrees"), (3, "Q")):
        check(bits_equal(torch, got[i].cpu(), want[i].cpu()),
              f"{MD_RUNNER_RANKS}-rank checkpoint resumed on one rank: {what} differ")
    for f in ("edges", "weights", "sizes", "n_supernodes", "n_superedges", "labels"):
        check(bits_equal(torch, getattr(got[2], f).cpu(), getattr(want[2], f).cpu()),
              f"{MD_RUNNER_RANKS}-rank checkpoint resumed on one rank: supergraph.{f} differs")
    multi = dict(lead["launches"])
    multi["near_field_rows"] = lead["grid_launches"]["near_field_rows"]
    return multi, lead["bf16_launches"]


def md_half_checks(np, ranks, half_positions) -> None:
    """Check 5 of ``multi_device_phase`` on the ranks' results."""
    s_layout = len(half_positions)
    scale = float(np.abs(half_positions).max())
    for r, (a, info) in enumerate(ranks):
        la, its = info["bf16_launches"], info["bf16_iterations"]
        check(its == ITERATIONS and la["repulsion_rows"] == its and la["attraction_sum"] == its
              and la["repulsion_nbody"] == 0,
              f"multi-device rank {r}: the bfloat16 layout ran {its} iterations with "
              f"launches K2 rows {la['repulsion_rows']}, attraction {la['attraction_sum']}, "
              f"whole K2 {la['repulsion_nbody']}")
        got = a["bf16_positions"][:s_layout]
        err = float(np.abs(got - half_positions).max())
        log(f"multi-device rank {r}: bfloat16 layout {info['bf16_s']:.3f} s, positions "
            f"against one rank max|Δ| {err} of {scale} (bitwise "
            f"{np.array_equal(got.view(np.uint32), half_positions.view(np.uint32))})")
        check(err <= HALF_CPU_TOL * scale,
              f"multi-device rank {r}: bfloat16 positions differ by {err} (> 2⁻⁷·{scale})")


# ------------------------------------------------------------- phase 11
def save_numbers(ck, smi: str) -> dict:
    """A checkpointer's saves, bytes and seconds, beside the card."""
    n = max(ck.saves, 1)
    return {"saves": ck.saves, "bytes_per_checkpoint": ck.last_bytes,
            "host_s_per_save": ck.host_s / n, "write_s_per_save": ck.write_s / n,
            "card": smi}


def resilience_phase(torch, np, cap: Capture, edges, res, cfg, main_wall: float, smi: str):
    """Checkpoint/resume and validated reads on phase 4's graph and config,
    streamed from an ``.npy`` store through the pinned staging ring.

    1. A run checkpointed at round boundaries is killed in detect (round 2,
       chunk ``n_chunks // 2``) and resumed with ``biggraphvis(...,
       resume=True)`` + ``render``, the counters set to 0 just before the
       resume and read just after: labels, graph degrees (the final
       checkpoint's, against a count on the host), sizes and the supergraph
       bitwise against phase 4, Q within 1e-6 and positions bitwise, the
       image written, K1, K2, K3, K4, K7 and K8 launched.
    2. A ``stream_pipeline`` run with one save inside the supergraph pass is
       killed after it and resumed: labels, degrees, supergraph and Q
       bitwise against an uninterrupted ``stream_pipeline`` on the card.
    3. The store behind two layers of ``ChaosEdgeStore``: transient I/O
       errors at two chunks and a transient truncated read (one failed
       attempt each), a permanently failing chunk and a bit-flip that
       recurs every pass, streamed with a ``ValidationPolicy``: retries,
       quarantined chunks, dropped rows and the ``errors.*`` counters as
       ``injected`` implies, and the result bitwise against a trusting card
       run on the equivalent in-memory array.
    """
    import repro_torch
    from repro_torch.data.edge_store import open_edge_store, write_npy
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.render import raster
    from repro_torch.render.png import read_png
    from repro_torch.resilience import (
        ChaosConfig,
        ChaosEdgeStore,
        KillSwitch,
        SimulatedPreemption,
        StreamCheckpointer,
        ValidationPolicy,
        load_arrays,
        latest_step,
    )

    from repro_torch.core.stream import EdgeChunkStream

    n = NODES
    scfg = repro_torch.StreamConfig(chunk_size=MAIN_CHUNK)
    layout = EdgeChunkStream(edges, n, MAIN_CHUNK, cfg.scoda.block_size)
    c, n_chunks = layout.chunk_size, layout.n_chunks
    passes = cfg.scoda.rounds + 1
    out = {"card": smi}

    def sg_equal(a, b, what):
        for f in ("edges", "weights", "sizes", "n_supernodes", "n_superedges", "labels"):
            check(bits_equal(torch, getattr(a, f).cpu(), getattr(b, f).cpu()),
                  f"{what}: supergraph.{f} differs")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        npy = write_npy(tmp / "edges.npy", edges)
        log(f"resilience: wrote {npy} in {time.perf_counter() - t0:.3f} s")

        # 1. Killed in detect, resumed through biggraphvis.
        kill_at = 2 * n_chunks + n_chunks // 2
        ck = StreamCheckpointer(str(tmp / "ck1"), every_chunks=0, on_boundary=KillSwitch(kill_at))
        t0 = time.perf_counter()
        try:
            repro_torch.biggraphvis(npy, n, cfg, scfg, checkpoint=ck, device="cuda")
            check(False, f"the run was not killed at boundary {kill_at}")
        except SimulatedPreemption as e:
            log(f"resilience: {e} after {time.perf_counter() - t0:.3f} s")
        check(ck.saves == 2, f"{ck.saves} round-boundary saves before the kill, expected 2")
        out["detect_saves"] = save_numbers(ck, smi)
        ck2 = StreamCheckpointer(str(tmp / "ck1"), every_chunks=0)
        png = str(tmp / "resumed.png")
        torch.cuda.synchronize()
        cap.reset()
        t0 = time.perf_counter()
        got = repro_torch.biggraphvis(npy, n, cfg, scfg, checkpoint=ck2, resume=True,
                                      device="cuda")
        image, _ = got.render(png)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cap.counts()
        out["resumed"] = {"resumed_at": got.stream.resumed_at, "wall_s": wall,
                          "main_path_wall_s": main_wall, "passes": got.stream.passes,
                          "saves": ck2.saves, "timings": got.timings, "launches": launches}
        log("resilience resumed run " + json.dumps(out["resumed"]))
        check(got.stream.resumed_at == "detect:r2:c0", f"resumed at {got.stream.resumed_at}")
        check(got.stream.passes == passes - 2, f"resumed run streamed {got.stream.passes} passes")
        check(np.array_equal(got.labels, res.labels), "resumed labels differ from phase 4")
        check(np.array_equal(got.sizes, res.sizes), "resumed sizes differ from phase 4")
        sg_equal(got.supergraph, res.supergraph, "resumed run")
        arrays, meta = load_arrays(str(tmp / "ck1"), latest_step(str(tmp / "ck1")))
        check(meta["phase"] == "supergraph" and meta["chunk"] == n_chunks,
              f"final checkpoint {meta}")
        deg = np.bincount(edges.reshape(-1), minlength=n).astype(np.int32)
        check(np.array_equal(arrays["deg"], deg), "resumed graph degrees differ from a host count")
        dq = abs(got.modularity - res.modularity)
        scale = float(np.abs(res.positions).max())
        perr = float(np.abs(got.positions - res.positions).max())
        log(f"resilience: Q {got.modularity} vs {res.modularity} (|ΔQ| {dq}); positions "
            f"max|Δ| {perr} of {scale}, bitwise {bool(np.array_equal(got.positions, res.positions))}")
        check(dq <= 1e-6, f"resumed Q differs by {dq}")
        check(np.array_equal(got.positions.view(np.uint8), res.positions.view(np.uint8)),
              f"resumed positions differ by {perr} of {scale}")
        check(np.isfinite(got.positions).all(), "non-finite resumed positions")
        check(np.array_equal(read_png(png), image), "resumed PNG round trip differs")
        frac, counts = raster.image_summary(image)
        check(frac >= 0.01 and (counts > 0).sum() >= 3,
              f"resumed image: {frac} non-background, {(counts > 0).sum()} colors")
        for k in sorted(MAIN_KERNELS):
            check(launches[k] > 0, f"kernel {k} was not launched in the resumed run")

        # 2. Killed in the supergraph pass, resumed through stream_pipeline.
        def pipeline(source, **kw):
            return repro_torch.stream_pipeline(
                source, n, cfg.scoda, cfg.cms, cfg.s_cap, cfg.max_super_edges,
                kw.pop("stream_cfg", scfg), device="cuda", **kw)

        want = pipeline(npy)
        # One save, after supergraph chunk n_chunks // 6 - 1; the kill a
        # quarter of the pass later.
        every = cfg.scoda.rounds * n_chunks + n_chunks // 6
        ck = StreamCheckpointer(str(tmp / "ck2"), every_chunks=every,
                                on_boundary=KillSwitch(every + n_chunks // 4))
        try:
            pipeline(npy, checkpoint=ck)
            check(False, "the supergraph-pass run was not killed")
        except SimulatedPreemption as e:
            log(f"resilience: {e}")
        check(ck.saves == 1, f"{ck.saves} saves before the supergraph-pass kill, expected 1")
        out["supergraph_saves"] = save_numbers(ck, smi)
        t0 = time.perf_counter()
        got2 = pipeline(npy, checkpoint=StreamCheckpointer(str(tmp / "ck2"), every_chunks=every),
                        resume=True)
        torch.cuda.synchronize()
        out["resumed_supergraph"] = {"resumed_at": got2[4].resumed_at,
                                     "seconds": time.perf_counter() - t0,
                                     "chunks": got2[4].chunks}
        check(got2[4].resumed_at == f"supergraph:r0:c{n_chunks // 6}",
              f"resumed at {got2[4].resumed_at}")
        check(got2[4].stage_seconds["detect_s"] == 0.0, "detect ran after a supergraph resume")
        for a, b, what in ((got2[0], want[0], "labels"), (got2[1], want[1], "graph degrees"),
                           (got2[3], want[3], "Q")):
            check(bits_equal(torch, a.cpu(), b.cpu()), f"supergraph-pass resume: {what} differ")
        sg_equal(got2[2], want[2], "supergraph-pass resume")

        # 3. Validated reads under injected faults, at chunks 7, 60, 33, 21
        # and 80 of 101.
        t1, t2, tr, bad, flip = (n_chunks * k // 101 for k in (7, 60, 33, 21, 80))
        transient = ChaosConfig(io_error_offsets=(t1 * c, t2 * c), truncate_offsets=(tr * c,),
                                truncate_rows=1000, transient_attempts=1)
        permanent = ChaosConfig(io_error_offsets=(bad * c,), bitflip_offsets=(flip * c,), seed=5)
        inner = ChaosEdgeStore(open_edge_store(npy), permanent)
        store = ChaosEdgeStore(inner, transient)
        policy = ValidationPolicy(max_retries=2, retry_backoff_s=0.001)
        before = {k: REGISTRY.counter(k).value for k in
                  ("errors.io_retries", "errors.quarantined_chunks", "errors.invalid_edges")}
        t0 = time.perf_counter()
        got3 = pipeline(store, stream_cfg=dataclasses.replace(scfg, validation=policy))
        torch.cuda.synchronize()
        chaos_s = time.perf_counter() - t0
        st = got3[4]
        moved = {k: REGISTRY.counter(k).value - v for k, v in before.items()}
        injected = {**{f"transient {k}": v for k, v in store.injected.items()},
                    **{f"permanent {k}": v for k, v in inner.injected.items()}}
        out["chaos"] = {"retries": st.retries, "quarantined_chunk_ids": st.quarantined_chunk_ids,
                        "dropped_edges": st.dropped_edges, "injected": injected,
                        "errors": moved, "seconds": chaos_s}
        log("resilience chaos run " + json.dumps(out["chaos"], default=str))
        failed = (sum(store.injected.values())
                  + sum(v for (kind, _), v in inner.injected.items() if kind == "io"))
        quarantines = passes * len(permanent.io_error_offsets)
        check(store.injected == {("io", t1 * c): 1, ("io", t2 * c): 1, ("trunc", tr * c): 1},
              f"transient faults fired {store.injected}")
        check(inner.injected == {("io", bad * c): passes * (policy.max_retries + 1),
                                 ("flip", flip * c): passes},
              f"permanent faults fired {inner.injected}")
        check(st.retries == failed - quarantines,
              f"{st.retries} retries; {failed} failed reads, {quarantines} quarantines")
        check(st.quarantined_chunk_ids == [bad], f"quarantined {st.quarantined_chunk_ids}")
        check(st.dropped_edges == inner.injected[("flip", flip * c)],
              f"{st.dropped_edges} dropped rows")
        check(moved == {"errors.io_retries": st.retries, "errors.quarantined_chunks": quarantines,
                        "errors.invalid_edges": st.dropped_edges}, f"errors.* moved {moved}")
        equiv = edges.copy()
        equiv[bad * c:(bad + 1) * c] = n
        row, _ = inner.flip_position(flip * c, c)
        equiv[flip * c + row] = n
        trusting = pipeline(equiv)
        for i, what in ((0, "labels"), (1, "graph degrees"), (3, "Q")):
            check(bits_equal(torch, got3[i].cpu(), trusting[i].cpu()),
                  f"validated run: {what} differ from the trusting run on the equivalent array")
        sg_equal(got3[2], trusting[2], "validated run")
    log("resilience numbers " + json.dumps(out, default=str))
    return out


# ------------------------------------------------------------- phase 12
def _lj_graph(torch, n_real: int, e_real: int, seed: int = 0):
    """soc-LiveJournal's counts (3,997,962 nodes, 34,681,189 edges), made on
    the card from a seeded generator: each edge's source uniform, its
    target in the source's block of LJ_BLOCK nodes with probability LJ_P_IN,
    else uniform. A few seconds of host time would become minutes for a
    planted partition at this size."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randint(0, n_real, (e_real,), generator=g, device="cuda", dtype=torch.int64)
    near = (u // LJ_BLOCK) * LJ_BLOCK + torch.randint(0, LJ_BLOCK, (e_real,), generator=g,
                                                      device="cuda")
    far = torch.randint(0, n_real, (e_real,), generator=g, device="cuda")
    inside = torch.rand(e_real, generator=g, device="cuda") < LJ_P_IN
    v = torch.where(inside, near.clamp(max=n_real - 1), far)
    return torch.stack([u, v], dim=1).to(torch.int32)


def _padded(torch, edges, e: int, trash: int):
    out = torch.full((e, 2), trash, dtype=torch.int32, device=edges.device)
    out[: edges.shape[0]] = edges
    return out


def _wall_ms(torch, fn, reps: int):
    """Mean host milliseconds of ``fn`` over ``reps`` calls, each ended by a
    device synchronize (a step of many launches, not one kernel)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def _same(torch, a, b) -> bool:
    return all(bits_equal(torch, x, y) for x, y in zip(a, b))


def dry_run_phase(torch, np, cap: Capture, edges) -> dict:
    """The BigGraphVis dry-run cells of ``repro_torch.configs.biggraphvis``
    at the reference's full padded shapes, through
    ``launch.steps.build_bgv_step`` on the card, the counters set to 0 just
    before each cell and read just after.

    * ``detect_berkstan`` on phase 4's graph padded with trash rows, and
      ``detect_livejournal`` on a graph made on the card (``_lj_graph``):
      one SCoDA round in one block plus K8's keys-in entry. Labels, degrees
      and sketch bitwise run to run and against the port on the CPU.
    * ``layout_berkstan`` and ``layout_livejournal`` (exact repulsion, K2)
      and a grid variant of ``layout_livejournal`` (grid 64, window 32,
      ``(cell, order)`` from ``bin_and_sort``; K5–K7) on seeded supergraph
      stand-ins: the step bitwise a direct ``fa2.step`` and run to run, and
      at berkstan within 1e-4·max|pos| of the CPU.
    Prints each cell's step time."""
    from repro_torch.configs import get_config
    from repro_torch.configs.biggraphvis import BGVDryConfig
    from repro_torch.core import forceatlas2 as fa2
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.launch.steps import build_bgv_step

    arch = get_config("biggraphvis")
    out = {}

    def detect(name, e_real_dev):
        shape = arch.shapes[name]
        n, e = shape.n_nodes, shape.n_edges
        step = build_bgv_step(arch, shape)
        ed = _padded(torch, e_real_dev, e, n)
        com0 = torch.arange(n + 1, dtype=torch.int32, device="cuda")
        deg0 = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        cap.reset()
        t0 = time.perf_counter()
        got = step.fn(com0, deg0, ed)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = cap.counts()
        ms, again = _wall_ms(torch, lambda: step.fn(com0, deg0, ed), 2)
        check(launches["cms_update_keys"] == 1, f"{name}: K8 launched {launches['cms_update_keys']}")
        check(_same(torch, got, again), f"{name}: two steps on the card differ")
        communities = int(torch.unique(got[0][:n]).numel())
        info = {"n_nodes": n, "n_edges": e, "real_edges": int(e_real_dev.shape[0]),
                "cms_cols": shape.n_out, "step_ms": ms, "first_step_s": first_s,
                "communities": communities, "launches": {k: v for k, v in launches.items() if v}}
        t0 = time.perf_counter()
        cpu = step.fn(com0.cpu(), deg0.cpu(), ed.cpu())
        info["cpu_s"] = time.perf_counter() - t0
        check(_same(torch, [x.cpu() for x in got], cpu),
              f"{name}: the card's labels, degrees or sketch differ from the CPU's")
        log(f"dry-run {name} " + json.dumps(info))
        check(communities < n, f"{name}: no community formed")
        out[name] = info

    bs = torch.as_tensor(edges, device="cuda")
    detect("detect_berkstan", bs)
    del bs
    lj = arch.shapes["detect_livejournal"]
    t0 = time.perf_counter()
    lj_edges = _lj_graph(torch, LJ_NODES, LJ_EDGES)
    torch.cuda.synchronize()
    log(f"livejournal-sized graph on the card: {LJ_NODES} nodes, {LJ_EDGES} edges in "
        f"{time.perf_counter() - t0:.3f} s; padded to {lj.n_nodes} / {lj.n_edges}")
    detect("detect_livejournal", lj_edges)
    del lj_edges
    torch.cuda.empty_cache()

    def layout(name, model: BGVDryConfig, cpu_check: bool):
        shape = arch.shapes[name.split("+")[0]]
        real_n, real_e = LAYOUT_REAL[shape.name]
        n, e = shape.n_nodes, shape.n_edges
        step = build_bgv_step(dataclasses.replace(arch, model=model), shape)
        rng = np.random.default_rng(SEED)
        pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
        mass = rng.integers(1, 200, n).astype(np.float32)
        ed = np.full((e, 2), n, np.int32)
        ed[:real_e] = rng.integers(0, real_n, (real_e, 2))
        w = rng.integers(1, 20, e).astype(np.float32)
        host = [pos, np.zeros_like(pos), mass, np.sqrt(mass), ed, w]
        args = [torch.as_tensor(x, device="cuda") for x in host]
        grid = model.layout_repulsion == "grid"
        if grid:
            args += list(grid_ops.bin_and_sort(args[0], model.layout_grid_size))
        cfg = fa2.FA2Config(iterations=1, use_radii=True, repulsion=model.layout_repulsion,
                            grid_size=model.layout_grid_size,
                            grid_window=model.layout_grid_window)
        torch.cuda.synchronize()
        cap.reset()
        got = step.fn(*args)
        torch.cuda.synchronize()
        launches = cap.counts()
        ms, again = _wall_ms(torch, lambda: step.fn(*args), 3)
        extra = dict(cell=args[6], order=args[7]) if grid else {}
        (d_pos, d_f, _), _ = fa2.step((args[0], args[1], torch.ones((), device="cuda")),
                                      args[4], args[5], args[2], args[3], cfg, n, **extra)
        check(_same(torch, got, again), f"{name}: two steps on the card differ")
        check(_same(torch, got, (d_pos, d_f)), f"{name}: the step differs from a direct fa2.step")
        # The step's two-scatter attraction: one layout of [u; v] and one
        # sum through it.
        want = ("far_field", "near_field", "segment_sum") if grid else ("repulsion_nbody",)
        for k in want + ("segment_offsets", "segment_sum_edges"):
            check(launches[k] == 1, f"{name}: {k} launched {launches[k]} times in one step")
        info = {"n_nodes": n, "n_edges": e, "real_nodes": real_n, "real_edges": real_e,
                "repulsion": model.layout_repulsion, "step_ms": ms,
                "launches": {k: v for k, v in launches.items() if v}}
        if cpu_check:
            t0 = time.perf_counter()
            cpu_pos, _ = step.fn(*[x.cpu() for x in args])
            info["cpu_s"] = time.perf_counter() - t0
            scale = float(cpu_pos.abs().max())
            info["max_abs_pos_vs_cpu"] = float((got[0].cpu() - cpu_pos).abs().max())
            check(info["max_abs_pos_vs_cpu"] <= 1e-4 * scale,
                  f"{name}: positions differ from the CPU by {info['max_abs_pos_vs_cpu']} "
                  f"(> 1e-4·{scale})")
        log(f"dry-run {name} " + json.dumps(info))
        out[name] = info
        if name == "layout_livejournal":
            with cap.recording("@step"):
                step.fn(*args)
            torch.cuda.synchronize()
            rows.append(time_edges_step(torch, cap, launches))
            cap.calls.clear()

    rows = []
    layout("layout_berkstan", BGVDryConfig(), True)
    layout("layout_livejournal", BGVDryConfig(), False)
    layout("layout_livejournal+grid", BGVDryConfig(layout_repulsion="grid",
                                                    layout_grid_size=GRID,
                                                    layout_grid_window=WINDOW), False)
    torch.cuda.empty_cache()
    return rows


def time_edges_step(torch, cap: Capture, launches: dict) -> dict:
    """K7's per-edge sum through a layout on the input one step of the
    ``layout_livejournal`` cell gave it: the two-scatter attraction's
    [f; −f] by [u; v] (narrow rows through the stable sort's order). The
    layout bitwise run to run; the sum bitwise its plain version on the
    CPU, the pre-change composition on the card (the stable sort, the
    sorted copy, the warp-per-segment kernel) and run to run; timed beside
    that composition, the plain version and ``index_add_`` on the kept
    rows, the layout build apart. ``launches``: the cell's step."""
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import segment_sum_layout_ref, segment_sum_ref

    _, (data, ids, n), _ = cap.calls["segment_sum_edges@step"]
    lay = seg_ops.segment_layout(ids, n)
    again = seg_ops.segment_layout(ids, n)
    check(bits_equal(torch, lay.perm, again.perm) and bits_equal(torch, lay.offsets, again.offsets),
          "K7 segment_sum_edges (step): two layout builds differ")
    got = seg_ops.segment_sum_edges(data, lay, n)
    check(bits_equal(torch, got, seg_ops.segment_sum_edges(data, lay, n)),
          "K7 segment_sum_edges (step): two launches differ")
    check(bits_equal(torch, got.cpu(), segment_sum_ref(data.cpu(), ids.cpu(), n)),
          "K7 segment_sum_edges (step): differs from the plain version on the CPU")
    check(bits_equal(torch, got, seg_ops.segment_sum(data, ids, n)),
          "K7 segment_sum_edges (step): differs from the pre-change composition")
    e, d = data.shape
    keep = (ids >= 0) & (ids < n)
    idx, data_k = ids[keep].long(), data[keep]
    out = torch.zeros((n, d), device=data.device)
    build_ms = cuda_ms(torch, lambda: seg_ops.segment_layout(ids, n), REPS)
    old_ms = cuda_ms(torch, lambda: seg_ops.segment_sum(data, ids, n), REPS)
    log(f"K7 segment_sum_edges (step): layout build {build_ms} ms, the pre-change composition "
        f"{old_ms} ms")
    largest = int(torch.diff(lay.offsets).max())
    return kernel_row(
        {"step": launches}, "segment_sum_edges",
        cuda_ms(torch, lambda: seg_ops.segment_sum_edges(data, lay, n), REPS),
        cuda_ms(torch, lambda: segment_sum_layout_ref(data, lay.perm, lay.offsets), REPS),
        cuda_ms(torch, lambda: out.index_add_(0, idx, data_k), REPS),
        0.0, *bytes_ops(seg_ops.sum_through_cost(e, d, n)),
        f"E={e} D={d} N={n} kept={idx.numel()} largest_segment={largest}; layout build "
        f"{build_ms} ms; pre-change composition {old_ms} ms", "index_add_ on the kept rows")


# ------------------------------------------------------------- phase 13
def _serve(torch, engine, reqs, record=None):
    """Serve ``reqs`` through ``engine`` (submitting as slots free up);
    returns (wall seconds, the most requests live at once, decode steps).
    With ``record`` (a dict) each live request's decode logits of every
    tick are kept under ``id(request)``."""
    decode, tick, last = engine._decode, engine.tick, {"steps": 0}

    def counting_decode(params, cache, batch):
        logits, cache = decode(params, cache, batch)
        last["logits"], last["steps"] = logits, last["steps"] + 1
        return logits, cache

    def recording_tick():
        live = dict(engine._live)
        done = tick()
        for slot, req in live.items():
            record.setdefault(id(req), []).append(last["logits"][slot, 0].float())
        return done

    engine._decode = counting_decode
    if record is not None:
        engine.tick = recording_tick
    torch.cuda.synchronize()
    backlog, most, t0 = list(reqs), 0, time.perf_counter()
    try:
        while backlog or engine.n_live:
            while backlog and engine.submit(backlog[0]):
                backlog.pop(0)
            most = max(most, engine.n_live)
            engine.tick()
        torch.cuda.synchronize()
    finally:
        engine._decode = decode
        if record is not None:
            del engine.tick  # the class's method again: an instance attribute
            # holding a bound method would keep the engine (and its weights
            # on the card) alive in a reference cycle after the phase
    return time.perf_counter() - t0, most, last["steps"]


def teacher_forced(torch, np, cfg, params, reqs, record, tol: float, name: str) -> dict:
    """The engine's gate: a prefill of each request's prompt and emitted
    tokens; at every generated position |decode − prefill| ≤ tol, and the
    emitted token's prefill logit ≥ the prefill's max − 2·tol."""
    from repro_torch.models import transformer as tfm

    prefill = tfm.make_prefill(cfg)
    worst, worst_gap = 0.0, 0.0
    for r in reqs:
        full = np.concatenate([r.prompt, r.out[:-1]]).astype(np.int32)
        want = prefill(params, {"tokens": torch.as_tensor(full, device="cuda")[None]})
        want = want[0, len(r.prompt) - 1:, : cfg.vocab].float()
        got = torch.stack(record[id(r)])[:, : cfg.vocab]
        check(got.shape == want.shape, f"{name}: {got.shape} decode rows for {want.shape}")
        worst = max(worst, float((got - want).abs().max()))
        picked = want.gather(1, torch.as_tensor(r.out, device="cuda")[:, None])[:, 0]
        worst_gap = max(worst_gap, float((want.max(dim=1).values - picked).max()))
    info = {"max_abs_decode_minus_prefill": worst, "max_prefill_gap_of_emitted": worst_gap,
            "tol": tol}
    log(f"{name} teacher-forced gate " + json.dumps(info))
    check(worst <= tol, f"{name}: decode and prefill logits differ by {worst} (> {tol})")
    check(worst_gap <= 2 * tol, f"{name}: an emitted token lies {worst_gap} below the "
                                f"prefill's max (> 2·{tol})")
    return info


def lm_engine_run(torch, np, cfg, params, n_req: int, new: int, name: str,
                  prompt_lens=(16, 64), slots: int = ENGINE_SLOTS) -> dict:
    """``LMEngine`` serving ``n_req`` requests (prompts of ``prompt_lens``
    tokens, ``new`` new tokens each) on ``slots`` slots × ENGINE_LEN
    positions, under the teacher-forced gate; then each request alone on the
    same engine in its slot, whose tokens must equal the concurrent run's
    (fault R5's repair)."""
    from repro_torch.serve.engine import LMEngine, Request

    tol = TF_TOL[str(cfg.act_dtype).removeprefix("torch.")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = LMEngine(cfg, params, n_slots=slots, max_len=ENGINE_LEN, device="cuda")
    rng = np.random.default_rng(SEED)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, int(rng.integers(*prompt_lens)))
                    .astype(np.int32), max_new=new) for _ in range(n_req)]
    record = {}
    wall, most, steps = _serve(torch, engine, reqs, record)
    peak = torch.cuda.max_memory_allocated()
    info = {"requests": n_req, "slots": slots, "positions": ENGINE_LEN,
            "prompt_tokens": sum(len(r.prompt) for r in reqs), "new_tokens": n_req * new,
            "most_live": most, "wall_s": wall, "decode_steps": steps,
            "ms_per_decode_step": wall / steps * 1e3, "tokens_per_s": n_req * new / wall,
            "peak_bytes": peak, "dtype": str(cfg.act_dtype), "layers": cfg.n_layers}
    check(all(len(r.out) == new and r.done for r in reqs), f"{name}: requests not served")
    check(most >= min(4, slots, n_req), f"{name}: at most {most} requests live at once")
    info.update(teacher_forced(torch, np, cfg, engine.params, reqs, record, tol, name))
    solo, solo_steps = 0.0, 0
    for r in reqs:
        alone = Request(prompt=r.prompt, max_new=new, slot=r.slot)
        w, _, k = _serve(torch, engine, [alone])
        solo, solo_steps = solo + w, solo_steps + k
        check(alone.slot == r.slot, f"{name}: the solo run took slot {alone.slot}")
        check(alone.out == r.out, f"{name}: request in slot {r.slot} got {r.out} together "
                                  f"and {alone.out} alone")
    info.update(solo_wall_s=solo, solo_ms_per_decode_step=solo / solo_steps * 1e3,
                concurrent_equals_solo=True)
    log(f"{name} engine " + json.dumps(info))
    return info


def seeded_params(specs, gen):
    """The smoke's own seeded weights for the full-width models: each leaf
    of ``specs`` in sorted key order, ``torch.randn`` on ``gen`` times its
    scale (``init_params``'s scale rule), zeros and ones as specified.
    These are not the reference's numbers: ``init_params`` draws those
    (threefry and the reference's ``erf_inv``, ``core/prng``), at ≈ 2 ns a
    value on the card, ≈ 10 s for yi-6b's 6.06e9 parameters, which the
    smoke draws ≈ 8 times; the smoke checks that draw on its own
    (``prng_checks``) and runs it for the small trees."""
    import torch

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        if tree.init in ("zeros", "ones"):
            return getattr(torch, tree.init)(tree.shape, dtype=tree.dtype, device=gen.device)
        x = torch.randn(tree.shape, generator=gen, dtype=torch.float32, device=gen.device)
        if tree.init == "scaled":
            fan_in = tree.shape[-2] if len(tree.shape) >= 2 else tree.shape[-1]
            return (x * (1.0 / math.sqrt(max(fan_in, 1)))).to(tree.dtype)
        return (x * tree.init_scale).to(tree.dtype)

    return fill(specs)


def sasrec_true_fan_in(cfg, p):
    """SASRec weights ``p`` with the attention weights rescaled in place to
    their true fan-in (``lm_params``'s rule: the reference's fan-in rule
    takes the [L, d, H, hd] attention weights' as H = 1, so its attention
    logits are an argmax, and a rounding's worth of change in the weights
    moves the scores by about SAS_TOL)."""
    for k in ("wq", "wk", "wv"):
        p["layers"][k] *= (cfg.n_heads / cfg.embed_dim) ** 0.5
    return p


def sasrec_params(cfg, gen):
    """Seeded random SASRec weights (``seeded_params``) at the true fan-in
    (``sasrec_true_fan_in``)."""
    from repro_torch.models import sasrec as sas_lib

    return sasrec_true_fan_in(cfg, seeded_params(sas_lib.param_specs(cfg), gen))


def lm_params(cfg, gen):
    """Seeded random LM weights (``seeded_params``) at the true fan-in of
    every product.

    ``init_params`` follows the reference's rule, fan-in = shape[-2], which
    for the stacked [L, d, H, hd] attention weights is H (or hd for wo),
    not the d (or H·hd) they contract over: at yi-6b's width the first
    layer's attention logits then reach a median of 237 and a maximum of
    1,455 (PERF.md §6, PR 21), so attention is an argmax that bfloat16
    rounding flips, and decode and prefill disagree by whole logits. Here
    wq, wk, wv are rescaled to 1/√d and wo to 1/√(H·hd); every other
    weight already has its true fan-in."""
    from repro_torch.models import transformer as tfm

    p = seeded_params(tfm.param_specs(cfg), gen)
    lyr = p["layers"]
    lyr["wq"] *= (cfg.n_heads / cfg.d_model) ** 0.5
    lyr["wk"] *= (cfg.n_kv_heads / cfg.d_model) ** 0.5
    lyr["wv"] *= (cfg.n_kv_heads / cfg.d_model) ** 0.5
    lyr["wo"] *= cfg.n_heads ** -0.5
    return p


GNN_SMALL_CELLS = (("gin-tu", "molecule"), ("gat-cora", "full_graph_sm"))


def gnn_cell_batch(np, name: str, cell: str):
    """``(arch, shape, model config, numpy batch)`` of gin-tu's ``molecule``
    (a ``MoleculeStream`` batch, padded to the cell) or a ``full_graph_sm``
    (a seeded graph at Cora's counts, padded; normal targets for a
    regression), checked against the cell's ``input_specs``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import input_specs
    from repro_torch.data.pipeline import MoleculeStream

    arch = get_config(name)
    shape = arch.shapes[cell]
    n, e = shape.n_nodes, shape.n_edges
    rng = np.random.default_rng(SEED)
    if cell == "molecule":
        b = MoleculeStream(shape.n_graphs, 30, 64, shape.d_feat, shape.n_out,
                           seed=SEED).batch_at(0)
        real_n = b["feats"].shape[0]
        feats = np.zeros((n, shape.d_feat), np.float32)
        feats[:real_n] = b["feats"]
        gids = np.full(n, shape.n_graphs, np.int32)
        gids[:real_n] = b["graph_ids"]
        ed = np.full((e, 2), n, np.int32)
        ed[: len(b["edges"])] = b["edges"]
        batch = {"feats": feats, "edges": ed, "graph_ids": gids, "labels": b["labels"],
                 "mask": b["mask"]}
    else:
        real_n, real_e = 2708, 10556  # Cora's counts
        feats = np.zeros((n, shape.d_feat), np.float32)
        feats[:real_n] = (rng.random((real_n, shape.d_feat)) < 0.0127).astype(np.float32)
        ed = np.full((e, 2), n, np.int32)
        ed[:real_e] = rng.integers(0, real_n, (real_e, 2))
        labels = (rng.standard_normal((n, shape.n_out)).astype(np.float32)
                  if shape.task == "node_reg"
                  else rng.integers(0, shape.n_out, n).astype(np.int32))
        batch = {"feats": feats, "edges": ed, "labels": labels,
                 "mask": (np.arange(n) < real_n).astype(np.float32)}
    for k, v in input_specs(arch, shape).items():
        check(tuple(batch[k].shape) == tuple(v.shape), f"{name}/{cell}: {k} shape")
    return arch, shape, arch.model_for(shape), batch


def models_phase(torch, np, cap: Capture, smi: str) -> dict:
    """The model substrate at the shapes of its configs, on the card
    (``repro_torch.models``, ``serve.engine``), seeded random weights (no
    published weights are in the repository), the counters set to 0 just
    before and read just after:

    The LMs' weights come from ``lm_params`` (true fan-in).

    * yi-6b at full width, ENGINE_LAYERS (28) of its 32 layers (21.2 GB
      of float32 parameters, cast once to bfloat16) through ``LMEngine``: 8 slots ×
      2,048 positions, 16 requests of 16–64 prompt tokens and 16 new
      tokens, at least 4 live at once; the teacher-forced gate
      (``teacher_forced``, TF_TOL) and every request's tokens equal to its
      solo run's (fault R5).
    * granite-moe-1b-a400m at full width and depth (24 layers, 32 experts,
      top 8), in float32: 4 requests of 8 new tokens under the same gates;
      its prefill reference takes a capacity that drops no token (decode
      drops none). Float32, because top-k routing is discontinuous: in
      bfloat16 the two paths' roundings move router logits across the
      top-8 boundary.
    * Card against CPU, float32, full width with the depth cut to 2
      layers, for both LMs: prefill logits within LM_CPU_TOL·max|logits|,
      and a short float32 engine run under the float32 gate.
    * SASRec at its full config, the reference's weights at the true
      fan-in (``sasrec_true_fan_in``): ``serve_p99`` (512 × 1,048,576 scores)
      and ``retrieval_cand`` (1,000,448 candidates), the retrieval scores
      equal to the serve scores at the candidates within SAS_TOL, and the
      first 8 rows of the serve scores within SAS_TOL of the CPU.
    * GNN: gin-tu on ``molecule`` (a ``MoleculeStream`` batch) and gat-cora
      on ``full_graph_sm`` (a seeded graph at Cora's counts): bitwise run
      to run (their segment sums go through K7), within GNN_TOL of the CPU.
    Prints tokens/s, ms per decode step and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import input_specs
    from repro_torch.core import prng
    from repro_torch.data.pipeline import SASRecStream
    from repro_torch.device import resolve_device
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import sasrec as sas_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import init_params, param_count, tree_leaves, tree_map

    resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on")
    out = {"card": smi}
    cap.reset()

    # yi-6b, full width, ENGINE_LAYERS of its 32 layers.
    yi = dataclasses.replace(get_config("yi-6b").model, n_layers=ENGINE_LAYERS)
    specs = tfm.param_specs(yi)
    t0 = time.perf_counter()
    params = lm_params(yi, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"yi-6b: {param_count(specs)} parameters, "
        f"{sum(t.numel() * t.element_size() for t in tree_leaves(params))} bytes in float32, "
        f"made on the card in {time.perf_counter() - t0:.3f} s")
    out["yi-6b"] = lm_engine_run(torch, np, yi, params, 16, 16, "yi-6b")
    del params
    torch.cuda.empty_cache()

    # granite-moe, full width and depth.
    gr = get_config("granite-moe-1b-a400m").model
    gr_nodrop = dataclasses.replace(gr, act_dtype=torch.float32, moe=dataclasses.replace(
        gr.moe, capacity_factor=gr.moe.n_experts / gr.moe.top_k))
    params = lm_params(gr_nodrop, torch.Generator(device="cuda").manual_seed(SEED))
    out["granite-moe-1b-a400m"] = lm_engine_run(torch, np, gr_nodrop, params, 4, 8,
                                                "granite-moe-1b-a400m (float32)")
    del params
    torch.cuda.empty_cache()

    # Card against CPU in float32, full width, 2 layers.
    for name, base in (("yi-6b", yi), ("granite-moe-1b-a400m", gr_nodrop)):
        cfg = dataclasses.replace(base, n_layers=2, act_dtype=torch.float32)
        host = lm_params(cfg, torch.Generator().manual_seed(SEED))
        dev = tree_map(lambda t: t.to("cuda"), host)
        toks = np.random.default_rng(SEED).integers(1, cfg.vocab, (1, 32)).astype(np.int32)
        prefill = tfm.make_prefill(cfg)
        got = prefill(dev, {"tokens": torch.as_tensor(toks, device="cuda")}).cpu()
        t0 = time.perf_counter()
        want = prefill(host, {"tokens": torch.as_tensor(toks)})
        cpu_s = time.perf_counter() - t0
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        log(f"{name} (2 layers, float32) prefill card against CPU: max|Δ| {err} of {scale} "
            f"({cpu_s:.3f} s on the CPU)")
        check(err <= LM_CPU_TOL * scale, f"{name}: card and CPU logits differ by {err}")
        out[f"{name}-2l-f32"] = lm_engine_run(torch, np, cfg, dev, 4, 8,
                                              f"{name} (2 layers, float32)")
        del host, dev
    torch.cuda.empty_cache()

    # SASRec at its full config.
    sas = get_config("sasrec")
    scfg = sas.model
    sp = sasrec_true_fan_in(scfg, init_params(prng.key(SEED), sas_lib.param_specs(scfg),
                                              device="cuda"))
    seq = SASRecStream(scfg.n_items, sas.shapes["serve_p99"].global_batch, scfg.seq_len,
                       seed=SEED).batch_at(0)["seq"]
    check(tuple(seq.shape) == tuple(input_specs(sas, sas.shapes["serve_p99"])["seq"].shape),
          "serve_p99 batch shape")
    seq_d = torch.as_tensor(seq, device="cuda")
    serve = sas_lib.make_serve_step(scfg)
    torch.cuda.reset_peak_memory_stats()
    serve_ms, scores = _wall_ms(torch, lambda: serve(sp, {"seq": seq_d}), 3)
    n_cand = sas.shapes["retrieval_cand"].n_candidates
    cand = torch.as_tensor(np.random.default_rng(SEED).integers(1, scfg.n_items, n_cand)
                           .astype(np.int32), device="cuda")
    retr = sas_lib.make_retrieval_step(scfg)
    retr_ms, rs = _wall_ms(torch, lambda: retr(sp, {"seq": seq_d[:1], "candidates": cand}), 3)
    check(scores.shape == (seq.shape[0], scfg.n_items) and bool(torch.isfinite(scores).all()),
          "serve_p99 scores")
    check(rs.shape == (n_cand,) and bool(torch.isfinite(rs).all()), "retrieval_cand scores")
    smax = float(scores.abs().max())
    rerr = float((rs - scores[0][cand.long()]).abs().max())
    cpu_scores = serve(tree_map(lambda t: t.cpu(), sp), {"seq": torch.as_tensor(seq[:8])})
    cerr = float((scores[:8].cpu() - cpu_scores).abs().max())
    info = {"serve_p99_ms": serve_ms, "retrieval_cand_ms": retr_ms,
            "scores_shape": list(scores.shape), "candidates": n_cand,
            "retrieval_vs_serve_max_abs": rerr, "cpu_max_abs": cerr, "max_abs_score": smax,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    log("sasrec " + json.dumps(info))
    check(rerr <= SAS_TOL * smax and cerr <= SAS_TOL * smax,
          f"sasrec: retrieval or CPU scores differ ({rerr}, {cerr} of {smax})")
    out["sasrec"] = info
    del sp, scores, rs
    torch.cuda.empty_cache()

    # GNN cells.
    for name, cell in GNN_SMALL_CELLS:
        arch, shape, gcfg, batch = gnn_cell_batch(np, name, cell)
        n, e = shape.n_nodes, shape.n_edges
        gp = init_params(prng.key(SEED), gnn_lib.param_specs(gcfg), device="cuda")
        bd = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
        before = cap.counts()["segment_sum_edges"]
        ms, got = _wall_ms(torch, lambda: gnn_lib.forward(gcfg, gp, bd), 3)
        again = gnn_lib.forward(gcfg, gp, bd)
        check(bits_equal(torch, got, again), f"{name}/{cell}: two forward passes differ")
        loss = float(gnn_lib.gnn_loss(gcfg, gp, bd))
        cpu = gnn_lib.forward(gcfg, tree_map(lambda t: t.cpu(), gp),
                              {k: torch.as_tensor(v) for k, v in batch.items()})
        err, scale = float((got.cpu() - cpu).abs().max()), float(cpu.abs().max())
        info = {"cell": cell, "n_nodes": n, "n_edges": e, "forward_ms": ms, "loss": loss,
                "out_shape": list(got.shape), "cpu_max_abs": err, "max_abs_out": scale,
                "k7_launches": cap.counts()["segment_sum_edges"] - before}
        log(f"{name} " + json.dumps(info))
        check(np.isfinite(loss) and bool(torch.isfinite(got).all()), f"{name}: non-finite")
        check(err <= GNN_TOL * scale, f"{name}/{cell}: card and CPU differ by {err} of {scale}")
        check(info["k7_launches"] > 0, f"{name}: K7 was not launched")
        out[name] = info
        del gp, bd, got, again
    launches = cap.counts()
    log("models launches " + json.dumps({k: v for k, v in launches.items() if v}))
    check(launches["segment_sum_edges"] > 0 and launches["segment_offsets"] > 0,
          "models: K7's layout build or per-edge sum was not launched")
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phase 14
# Training: full-width runs take TRAIN_STEPS steps each; the runs against
# the CPU TRAIN_CMP_STEPS. yi-6b's depth is the deepest whose estimate
# (lm_train_estimate) stays under TRAIN_BUDGET bytes; granite-moe runs at
# full depth, SASRec's train_batch uncut, gin-tu on ogbn-products' counts.
TRAIN_STEPS, TRAIN_CMP_STEPS, TRAIN_BUDGET = 3, 2, 70e9
TRAIN_LM_TOKENS = {"yi-6b": (1, 4096), "granite-moe-1b-a400m": (2, 4096)}
TRAIN_CMP_TOKENS, TRAIN_CMP_SAS_BATCH = (1, 32), 256
# ogbn-products' true counts (the cell pads them to 2,449,408 and
# 61,859,328), made on the card as the dry-run phase makes LiveJournal's.
PRODUCTS_NODES, PRODUCTS_EDGES = 2_449_029, 61_859_140
# Card against CPU after TRAIN_CMP_STEPS steps, float32, TF32 off: each
# step's loss and grad norm within a relative tolerance, and each parameter
# tensor within tol_p·max|p|: (tol_loss, tol_gnorm, tol_p) by family, about
# 3× the worst measured on an H100 80GB HBM3 at 700 W (PERF.md §6,
# training): LMs 1.4e-6, 1.5e-6, 4.3e-3 (granite's; AdamW's first steps
# move an element whose gradient is near zero by up to lr whatever the
# gradient's size, so there a rounding-level difference moves it by a
# fraction of lr, 0.48·lr at worst); GNNs 6.0e-8, 6.2e-8, 5.5e-6; SASRec
# (true fan-in) 0, 1.1e-7, 4.5e-5.
TRAIN_TOL = {"lm": (5e-6, 5e-6, 1.5e-2), "gnn": (2e-7, 2e-7, 1.5e-5),
             "sasrec": (2e-7, 3e-7, 1.5e-4)}
LR = 1e-3  # AdamWConfig's default: every run of the phase but the full-width LMs'
# The full-width LMs take the learning rate of a warm-up's first steps:
# AdamW's first steps move every weight by ≈ lr in its gradient's sign,
# which moves a width-d product by ≈ 0.8·lr·d of its scale. At lr 1e-3,
# yi-6b (17 layers) went from loss 11.6 to 17.5 in 3 steps (PERF.md §6),
# and the reference diverges alike at full width: 11.06 → 18.66 → 24.58
# over 3 steps at 2 layers, the port within 1.1e-6 of it
# (tests/torch_lm_lr_witness.py, the configuration of the 2-layer gate
# below, which holds the card's full-width backward at lr 1e-3).
LM_LR = 1e-5
TRAIN_KILL_ARGS = ["--arch", "gin-tu", "--preset", "smoke", "--steps", "20",
                   "--ckpt-every", "5"]
TRAIN_KILL_AT = 12
# Fault injection from outside the launcher: ``launch.train.main`` with its
# step function wrapped so that the process SIGKILLs itself right after step
# ``argv[1]`` (counted from a fresh start) and before that step's checkpoint.
TRAIN_KILL_HARNESS = """
import os, signal, sys
import repro_torch.launch.train as launcher
kill_at, make = int(sys.argv[1]), launcher.make_train_step
def make_killed(*args, **kwargs):
    step_fn, calls = make(*args, **kwargs), [0]
    def step(*a):
        out = step_fn(*a)
        if calls[0] == kill_at:
            float(out[2]["loss"])
            print(f"step {kill_at}: killed", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        calls[0] += 1
        return out
    return step
launcher.make_train_step = make_killed
launcher.main(sys.argv[2:])
"""


def lm_train_estimate(torch, cfg, rows: int, seq: int, bits: int) -> int:
    """Device bytes of an LM train step: parameters, gradients and AdamW
    state (4 + 4 + 8 bytes a parameter, or 4 + 4 + ≈ 1 at 8 bits), the
    layer weights cast to the activation type, each layer's saved input
    (remat), one layer's attention (float32 softmax and its cast, a row of
    heads at a time), its MLP, and the float32 logits with their gradient."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import param_count

    specs = tfm.param_specs(cfg)
    p = param_count(specs)
    p_layers = param_count(specs["layers"])
    a = 2 if cfg.act_dtype == torch.bfloat16 else 4
    t = rows * seq
    if cfg.moe is None:
        ff = t * cfg.d_ff
    else:
        ff = int(t * cfg.moe.top_k * cfg.moe.capacity_factor) * cfg.moe.d_ff_expert
    state = 8 if bits == 32 else 1
    return int(p * (8 + state) + (p_layers * a if a < 4 else 0) + cfg.n_layers * t * cfg.d_model * a
               + rows * cfg.n_heads * seq * seq * (4 + a) + 6 * ff * a
               + 4 * t * cfg.vocab_padded * 4)


def train_run(torch, loss_fn, params, batches, bits: int = 32, microbatch: int = 0,
              lr: float = LR) -> tuple:
    """``len(batches)`` steps of ``make_train_step(loss_fn)`` with AdamW at
    ``lr``; parameters and state updated in place. Returns ``(params,
    state, info)`` with each step's loss, grad norm and wall ms (host clock
    around a step ended by its loss's read)."""
    from repro_torch.models.param import tree_leaves
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=lr, state_bits=bits), microbatch=microbatch)
    state = opt.init_opt_state(params, tcfg.adamw)
    step = make_train_step(loss_fn, tcfg)
    cuda = tree_leaves(params)[0].is_cuda
    info = {"losses": [], "grad_norms": [], "step_ms": []}
    for b in batches:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        info["losses"].append(float(m["loss"]))
        info["grad_norms"].append(float(m["grad_norm"]))
        info["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return params, state, info


def loss_gate(np, name: str, losses) -> None:
    """Every loss finite, the last below the first + 0.5 (the reference's
    criterion, tests/test_arch_smoke.py)."""
    check(bool(np.isfinite(losses).all()), f"{name}: a non-finite loss {losses}")
    check(losses[-1] < losses[0] + 0.5, f"{name}: loss {losses[0]} → {losses[-1]}")


def _tree_to(tree, device):
    from repro_torch.models.param import tree_map

    return tree_map(lambda t: t.to(device, copy=True), tree)


def _flip_share(torch, a, b, lr: float, steps: int) -> tuple:
    """(share of elements off by more than 1e-6·max|b| + 2e-3·lr, leaf by
    leaf; every element within AdamW's reach 2.02·lr·steps·(1 + 0.01|b|))
    of two parameter trees, on their device."""
    from repro_torch.models.param import tree_leaves

    off = total = 0
    reach = True
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.float(), y.float()
        d = (x - y).abs()
        off += int((d > 1e-6 * float(y.abs().max()) + 2e-3 * lr).sum())
        total += d.numel()
        reach &= bool((d <= 2.02 * lr * steps * (1 + 0.01 * y.abs())).all())
    return off / max(total, 1), reach


def _max_rel(torch, a, b) -> float:
    """max over leaves of max|a − b| / max|b| (0 for two zero tensors)."""
    from repro_torch.models.param import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = float((x.float().cpu() - y.float().cpu()).abs().max())
        worst = max(worst, d / max(float(y.float().abs().max()), 1e-30))
    return worst


def card_against_cpu(torch, np, name: str, family: str, loss_fn, host_params, host_batches):
    """The first TRAIN_CMP_STEPS of ``host_batches`` on the card and on the
    CPU from the same parameters: the gate TRAIN_TOL[family]. Then two runs
    of all of ``host_batches`` (TRAIN_STEPS) on the card from the same
    parameters: their run to run measured (bitwise or not), gated only for
    the GNNs."""
    from repro_torch.models.param import tree_leaves

    dev_batches = [{k: v.to("cuda") for k, v in b.items()} for b in host_batches]
    card, _, card_info = train_run(torch, loss_fn, _tree_to(host_params, "cuda"),
                                   dev_batches[:TRAIN_CMP_STEPS])
    runs = [train_run(torch, loss_fn, _tree_to(host_params, "cuda"), dev_batches)[:2]
            for _ in range(2)]
    t0 = time.perf_counter()
    cpu, _, cpu_info = train_run(torch, loss_fn, host_params, host_batches[:TRAIN_CMP_STEPS])
    cpu_s = time.perf_counter() - t0
    tol_loss, tol_gnorm, tol_p = TRAIN_TOL[family]
    loss_err = max(abs(a / b - 1) for a, b in zip(card_info["losses"], cpu_info["losses"]))
    gnorm_err = max(abs(a / b - 1)
                    for a, b in zip(card_info["grad_norms"], cpu_info["grad_norms"]))
    p_err = _max_rel(torch, card, cpu)
    worst = max(((float((x.cpu() - y).abs().max()) / LR, i)
                 for i, (x, y) in enumerate(zip(tree_leaves(card), tree_leaves(cpu)))))
    bitwise = _same(torch, tree_leaves({"p": runs[0][0], "s": runs[0][1]}),
                    tree_leaves({"p": runs[1][0], "s": runs[1][1]}))
    info = {"losses_card": card_info["losses"], "losses_cpu": cpu_info["losses"],
            "grad_norms_card": card_info["grad_norms"], "grad_norms_cpu": cpu_info["grad_norms"],
            "loss_rel": loss_err, "grad_norm_rel": gnorm_err, "param_max_rel": p_err,
            "param_max_abs_over_lr": worst[0], "worst_leaf": worst[1],
            "tol": TRAIN_TOL[family], "card_run_to_run_bitwise": bitwise,
            "card_run_to_run_param_max_rel": _max_rel(torch, runs[0][0], runs[1][0]),
            "cpu_seconds": cpu_s}
    log(f"{name} card against CPU after {TRAIN_CMP_STEPS} steps, card run to run after "
        f"{len(host_batches)} " + json.dumps(info))
    check(loss_err <= tol_loss and gnorm_err <= tol_gnorm,
          f"{name}: card and CPU loss or grad norm differ ({loss_err}, {gnorm_err})")
    check(p_err <= tol_p, f"{name}: card and CPU parameters differ by {p_err} of max|p|")
    if family == "gnn":
        check(bitwise, f"{name}: two runs on the card differ")
    return info


def products_batch(torch, shape, seed: int = SEED) -> dict:
    """gin-tu's ``ogb_products`` cell on the card: ogbn-products' node and
    edge counts (the dataset is not in the repository) as ``_lj_graph``
    makes them, padded with the trash id; seeded float32 features, labels
    of the cell's 47 classes, every real node in the loss."""
    n, e = shape.n_nodes, shape.n_edges
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    edges = _padded(torch, _lj_graph(torch, PRODUCTS_NODES, PRODUCTS_EDGES, seed), e, n)
    feats = torch.zeros((n, shape.d_feat), device="cuda")
    feats[:PRODUCTS_NODES] = torch.randn((PRODUCTS_NODES, shape.d_feat), generator=g,
                                         device="cuda")
    labels = torch.randint(0, shape.n_out, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    mask = (torch.arange(n, device="cuda") < PRODUCTS_NODES).to(torch.float32)
    return {"feats": feats, "edges": edges, "labels": labels, "mask": mask}


def time_k7_train(torch, rows: list, launches: dict, edges, n: int, d: int):
    """K7's training entries on ogb_products' edges (seeded [E, d] float32
    terms): the layout of each id array (dst for the message sum, src for
    the gather backward), built twice and bitwise, and the sum through it.
    Each sum bitwise the pre-change composition (a stable sort of the ids,
    the rows copied into its order, the warp-per-segment kernel) in the
    same call and run to run, within 2γ(k−1)·Σ|x| per segment of the card's
    plain version (in row chunks: the float64 bound of the whole input would
    be 32 GB); timed beside that composition, the plain version and
    ``index_add_`` on the kept rows. The layout build is timed apart: its
    offsets entry alone (``segment_offsets_train``, from the sorted ids) and
    the whole build (stable sort, int32 cast, offsets)."""
    from repro_torch.kernels.segment import ops as seg_ops
    from repro_torch.kernels.segment.ref import segment_offsets_ref, segment_sum_ref

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    e = edges.shape[0]
    data = torch.randn((e, d), generator=g, device="cuda")
    for name, col, counter in (("segment_sum_edges_train", 1, "segment_sum_edges"),
                               ("segment_sum_gather_bwd", 0, "segment_sum_gather_bwd")):
        seg = edges[:, col].contiguous()
        lay = seg_ops.segment_layout(seg, n)
        again = seg_ops.segment_layout(seg, n)
        check(bits_equal(torch, lay.perm, again.perm)
              and bits_equal(torch, lay.offsets, again.offsets),
              f"K7 {name}: two layout builds differ")
        del again
        if col == 1:
            sid = seg[lay.perm.long()]
            srt = seg_ops.segment_layout(sid, n, sorted=True)
            check(bits_equal(torch, srt.offsets, lay.offsets),
                  "K7 segment_offsets_train: the sorted ids' offsets differ")
            marks = torch.arange(n + 1, dtype=torch.int32, device="cuda")
            build_ms = cuda_ms(torch, lambda: seg_ops.segment_layout(seg, n), 5)
            log(f"K7 layout build on ogb_products' dst (stable sort, int32 cast, offsets): "
                f"{build_ms} ms")
            rows.append(kernel_row(
                {"train": launches}, "segment_offsets_train",
                cuda_ms(torch, lambda: seg_ops.segment_offsets(sid, n), REPS),
                cuda_ms(torch, lambda: segment_offsets_ref(sid, n), REPS),
                cuda_ms(torch, lambda: torch.searchsorted(sid, marks), REPS),
                0.0, *bytes_ops(seg_ops.segment_offsets_cost(e, n)),
                f"E={e} N={n} sorted ids (dst); the whole build {build_ms} ms",
                "searchsorted of every segment id in the sorted ids"))
            del sid, srt, marks

        def k7():
            return seg_ops._sum_through(data, lay, counter)

        got = k7()
        check(bits_equal(torch, got, k7()), f"K7 {name}: two launches differ")
        old = seg_ops.segment_sum(data, seg, n)
        check(bits_equal(torch, got, old), f"K7 {name}: differs from the pre-change composition")
        del old
        old_ms = cuda_ms(torch, lambda: seg_ops.segment_sum(data, seg, n), 3)
        log(f"K7 {name}: the pre-change composition (sort, sorted copy, the warp-per-segment "
            f"kernel) {old_ms} ms")
        torch.cuda.empty_cache()
        plain = segment_sum_ref(data, seg, n)
        keep = (seg >= 0) & (seg < n)
        idx = seg[keep].long()
        k = torch.bincount(idx, minlength=n).double()
        absum = torch.zeros((n, d), dtype=torch.float64, device="cuda")
        for i0 in range(0, e, 1 << 22):
            s, x = seg[i0:i0 + (1 << 22)], data[i0:i0 + (1 << 22)]
            kk = (s >= 0) & (s < n)
            absum.index_add_(0, s[kk].long(), x[kk].double().abs())
        m = torch.clamp(k - 1, min=0) * 2.0**-24
        err = (got.double() - plain.double()).abs()
        check(bool((err <= (2 * m / (1 - m))[:, None] * absum).all()),
              f"K7 {name}: |Δ| above 2γ(k−1)·Σ|x| of the card's plain version")
        del absum, plain, got
        data_k = data[keep]
        out = torch.zeros((n, d), device="cuda")
        lib = cuda_ms(torch, lambda: out.index_add_(0, idx, data_k), 5)
        del data_k, out
        largest = int(k.max())
        rows.append(kernel_row(
            {"train": launches}, name, cuda_ms(torch, k7, 5),
            cuda_ms(torch, lambda: segment_sum_ref(data, seg, n), 3), lib,
            float(err.max()), *bytes_ops(seg_ops.sum_through_cost(e, d, n)),
            f"E={e} D={d} N={n} through a layout of {'dst' if col else 'src'} "
            f"largest_segment={largest}; pre-change composition {old_ms} ms",
            "index_add_ on the kept rows"))
        del err, lay
        torch.cuda.empty_cache()


def train_launcher_round_trip(np) -> dict:
    """``python -m repro_torch.launch.train`` on the card: TRAIN_KILL_ARGS
    uninterrupted (exit 0), and killed (SIGKILL, TRAIN_KILL_HARNESS) after
    step TRAIN_KILL_AT, both at once, then resumed: it must restore the step-10
    checkpoint, and its final checkpoint must equal the uninterrupted run's
    bit for bit."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_KILL_ARGS]
    kill_cmd = [sys.executable, "-c", TRAIN_KILL_HARNESS, str(TRAIN_KILL_AT), *TRAIN_KILL_ARGS]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c + ["--ckpt-dir", f"{d}/{tag}"], cwd=ROOT,
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for tag, c in (("whole", cmd), ("killed", kill_cmd))]
        outs = [p.communicate(timeout=LAUNCHER_TIMEOUT)[0] for p in procs]
        check(procs[0].returncode == 0, f"train launcher exited {procs[0].returncode}:\n"
                                        f"{outs[0][-3000:]}")
        check(procs[1].returncode == -9 and f"step {TRAIN_KILL_AT}: killed" in outs[1],
              f"killed train launcher exited {procs[1].returncode}:\n{outs[1][-3000:]}")
        res = subprocess.run(cmd + ["--ckpt-dir", f"{d}/killed"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=LAUNCHER_TIMEOUT)
        check(res.returncode == 0, f"resumed train launcher exited {res.returncode}:\n"
                                   f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        check("restored checkpoint @ step 10" in res.stdout,
              f"the resumed run did not restore step 10:\n{res.stdout[-2000:]}")
        last = "step_00000019.npz"
        with np.load(f"{d}/whole/{last}") as a, np.load(f"{d}/killed/{last}") as b:
            same = sorted(a.files) == sorted(b.files) and all(
                a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a.files)
            n_arrays = len(a.files)
        info = {"wall_s": time.perf_counter() - t0, "arrays": n_arrays,
                "resumed_bitwise": same,
                "whole_tail": outs[0].strip().splitlines()[-1]}
    log("train launcher kill at step 12 and resume " + json.dumps(info))
    check(same, "the resumed run's final checkpoint differs from the uninterrupted run's")
    return info


def training_phase(torch, np, cap: Capture, smi: str) -> list:
    """Training on the card (``repro_torch.train``), through
    ``make_train_step`` and ``python -m repro_torch.launch.train``, seeded
    random weights (the LMs' at the true fan-in, ``lm_params``), AdamW at
    LR, TF32 off. A memory estimate is printed before each full-width run
    and its peak after it.

    * yi-6b ``train_4k`` at full width, depth cut to the deepest under
      TRAIN_BUDGET (parameters, gradients, m and v in float32 take 16 B a
      parameter: all 32 layers would need 97 GB), one 4,096-token row;
      granite-moe-1b-a400m at full width and depth, 2 × 4,096 tokens, with
      the float32 and the 8-bit state; SASRec ``train_batch`` uncut
      (65,536 × 50); gin-tu ``ogb_products`` at ogbn-products' counts
      (remat on), twice from the same parameters, bitwise. Each run
      TRAIN_STEPS steps: step ms, tokens/s, peak bytes; every loss finite
      and the last below the first + 0.5.
    * Card against CPU (``card_against_cpu``), float32: yi-6b and granite
      at full width and 2 layers (32 tokens), gin-tu ``molecule``,
      gat-cora ``full_graph_sm``, SASRec at a batch of 256; the card's run
      to run measured (the LMs' and SASRec's embedding gathers add their
      gradients with ``index_put_``), and held bitwise for the GNNs.
    * K7: every GNN run launches its per-edge entry (forward sums and the
      remat recompute) and its gather backward; both are timed on
      ogb_products' edges (``time_k7_train``) for the ``kernels`` line.
    * The launcher: ``train_launcher_round_trip``.
    Returns the ``kernels`` rows of K7's two training entries."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import LMStream, SASRecStream
    from repro_torch.device import resolve_device
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import sasrec as sas_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import init_params, param_count, tree_leaves

    resolve_device("cuda")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"training: {torch.cuda.memory_allocated()} bytes allocated on the card at the start")
    out = {"card": smi}
    rows = []

    def lm_batches(cfg, shape_rows, seq, host=False):
        stream = LMStream(cfg.vocab, shape_rows, seq, seed=SEED)
        dev = "cpu" if host else "cuda"
        return [{k: torch.as_tensor(v, device=dev) for k, v in stream.batch_at(i).items()}
                for i in range(TRAIN_STEPS)]

    def full_run(name, cfg, loss_fn, params, batches, est, tokens, bits=32, microbatch=0,
                 lr=LR, kind="lm"):
        log(f"{name}: estimate {est} bytes ({est / 1e9:.1f} GB) of device memory")
        # An earlier run's tensors held only by reference cycles (the remat
        # checkpoints' frames) would otherwise be freed at some point of
        # this run, and count in its peak until then.
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        recipe = {"name": name, "loss_fn": loss_fn, "params": _shapes(params),
                  "batch": _shapes(batches[0]), "bits": bits, "microbatch": microbatch,
                  "lr": lr, "before": before, "estimate": est, "kind": kind}
        params, state, info = train_run(torch, loss_fn, params, batches, bits, microbatch, lr)
        info["lr"] = lr
        info["peak_bytes"] = torch.cuda.max_memory_allocated()
        TRAIN_RUNS.append(recipe | {"peak": info["peak_bytes"]})
        info["estimate_bytes"] = est
        info["tokens_per_step"] = tokens
        info["tokens_per_s"] = [tokens / ms * 1e3 for ms in info["step_ms"]]
        log(f"{name} train " + json.dumps(info))
        loss_gate(np, name, info["losses"])
        return params, state, info

    # yi-6b train_4k, full width, depth cut.
    yi_arch = get_config("yi-6b")
    rows_, seq = TRAIN_LM_TOKENS["yi-6b"]
    depth = max(n for n in range(1, yi_arch.model.n_layers + 1)
                if lm_train_estimate(torch, dataclasses.replace(yi_arch.model, n_layers=n), rows_, seq,
                                     yi_arch.opt_state_bits) <= TRAIN_BUDGET)
    yi = dataclasses.replace(yi_arch.model, n_layers=depth)
    log(f"yi-6b train_4k: {depth} of {yi_arch.model.n_layers} layers, "
        f"{param_count(tfm.param_specs(yi))} of {param_count(tfm.param_specs(yi_arch.model))} "
        "parameters")
    params = lm_params(yi, torch.Generator(device="cuda").manual_seed(SEED))
    params, state, out["yi-6b"] = full_run(
        f"yi-6b ({depth} layers)", yi, functools.partial(tfm.lm_loss, yi), params,
        lm_batches(yi, rows_, seq), lm_train_estimate(torch, yi, rows_, seq, yi_arch.opt_state_bits),
        rows_ * seq, yi_arch.opt_state_bits, yi_arch.microbatch_train, LM_LR)
    out["yi-6b"]["layers"] = depth
    del params, state
    torch.cuda.empty_cache()

    # granite-moe, full width and depth, float32 and 8-bit state.
    gr_arch = get_config("granite-moe-1b-a400m")
    gr = gr_arch.model
    rows_, seq = TRAIN_LM_TOKENS["granite-moe-1b-a400m"]
    for bits in (32, 8):
        params = lm_params(gr, torch.Generator(device="cuda").manual_seed(SEED))
        params, state, out[f"granite-moe-{bits}"] = full_run(
            f"granite-moe-1b-a400m (state {bits} bits)", gr, functools.partial(tfm.lm_loss, gr),
            params, lm_batches(gr, rows_, seq), lm_train_estimate(torch, gr, rows_, seq, bits),
            rows_ * seq, bits, lr=LM_LR)
        del params, state
        torch.cuda.empty_cache()

    # The LMs against the CPU: full width, 2 layers, float32.
    for name, base in (("yi-6b", yi_arch.model), ("granite-moe-1b-a400m", gr)):
        cfg = dataclasses.replace(base, n_layers=2, act_dtype=torch.float32)
        host = lm_params(cfg, torch.Generator().manual_seed(SEED))
        out[f"{name}-2l-f32-cmp"] = card_against_cpu(
            torch, np, f"{name} (2 layers, float32)", "lm", functools.partial(tfm.lm_loss, cfg),
            host, lm_batches(cfg, *TRAIN_CMP_TOKENS, host=True))
        del host
    torch.cuda.empty_cache()

    # SASRec train_batch, uncut, and against the CPU at a cut batch.
    sas = get_config("sasrec")
    scfg = sas.model
    sb = sas.shapes["train_batch"].global_batch
    sparams = sasrec_params(scfg, torch.Generator(device="cuda").manual_seed(SEED))
    stream = SASRecStream(scfg.n_items, sb, scfg.seq_len, seed=SEED)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS)]
    p_sas = param_count(sas_lib.param_specs(scfg))
    est = p_sas * 16 + sb * scfg.seq_len * (scfg.seq_len * 12 + scfg.embed_dim * 4 * 24)
    sparams, sstate, out["sasrec"] = full_run(
        "sasrec train_batch", scfg, functools.partial(sas_lib.sasrec_loss, scfg), sparams,
        batches, est, sb * scfg.seq_len, kind="sasrec")
    del sparams, sstate, batches
    torch.cuda.empty_cache()
    host = sasrec_params(scfg, torch.Generator().manual_seed(SEED))
    hs = SASRecStream(scfg.n_items, TRAIN_CMP_SAS_BATCH, scfg.seq_len, seed=SEED)
    out["sasrec-cmp"] = card_against_cpu(
        torch, np, f"sasrec (batch {TRAIN_CMP_SAS_BATCH})", "sasrec",
        functools.partial(sas_lib.sasrec_loss, scfg), host,
        [{k: torch.as_tensor(v) for k, v in hs.batch_at(i).items()}
         for i in range(TRAIN_STEPS)])
    del host

    # GNNs: the small cells against the CPU and bitwise run to run.
    for name, cell in GNN_SMALL_CELLS:
        arch, shape, gcfg, batch = gnn_cell_batch(np, name, cell)
        host = init_params(prng.key(SEED), gnn_lib.param_specs(gcfg), device="cpu")
        cap.reset()
        info = card_against_cpu(torch, np, f"{name}/{cell}", "gnn",
                                functools.partial(gnn_lib.gnn_loss, gcfg), host,
                                [{k: torch.as_tensor(v) for k, v in batch.items()}]
                                * TRAIN_STEPS)
        launches = cap.counts()
        info["launches"] = {k: launches[k] for k in ("segment_offsets", "segment_sum_edges",
                                                     "segment_sum_gather_bwd")}
        check(min(info["launches"].values()) > 0, f"{name}/{cell}: K7 not launched "
                                                  f"in training: {info['launches']}")
        out[f"{name}/{cell}"] = info

    # gin-tu on ogb_products, twice from the same parameters.
    arch = get_config("gin-tu")
    shape = arch.shapes["ogb_products"]
    gcfg = arch.model_for(shape)
    check(gcfg.remat, "ogb_products: remat is off")
    t0 = time.perf_counter()
    batch = products_batch(torch, shape)
    torch.cuda.synchronize()
    log(f"ogb_products batch: {shape.n_nodes} nodes, {shape.n_edges} edges, made on the card "
        f"in {time.perf_counter() - t0:.3f} s")
    p0 = init_params(prng.key(SEED), gnn_lib.param_specs(gcfg), device="cuda")
    e, d = shape.n_edges, gcfg.d_hidden
    est = 3 * e * d * 4 + e * 8 * 3 + shape.n_nodes * (shape.d_feat + 16 * d) * 4
    loss_fn = functools.partial(gnn_lib.gnn_loss, gcfg)
    runs = []
    for k in range(2):
        cap.reset()
        p, st, info = full_run(f"gin-tu/ogb_products run {k + 1}", gcfg, loss_fn,
                               _tree_to(p0, "cuda"), [batch] * TRAIN_STEPS, est, shape.n_nodes,
                               kind="gnn")
        runs.append((p, st, info, cap.counts()))
        info["launches"] = {c: v for c, v in runs[-1][3].items() if v}
    train_launches = runs[0][3]
    same = _same(torch, tree_leaves({"p": runs[0][0], "s": runs[0][1]}),
                 tree_leaves({"p": runs[1][0], "s": runs[1][1]}))
    out["gin-tu/ogb_products"] = runs[0][2] | {"run_to_run_bitwise": same}
    log(f"gin-tu/ogb_products launches per run of {TRAIN_STEPS} steps "
        + json.dumps(runs[0][2]["launches"]))
    check(same, "gin-tu/ogb_products: two runs of the same steps differ")
    # A gin-tu step (5 layers, remat): one forward builds the layouts of
    # src and dst; its 10 sums run twice (the forward and the recompute),
    # its 10 gathers' backwards once, each through a layout, none sorting.
    want = {"segment_offsets": 2, "segment_sum_edges": 20, "segment_sum_gather_bwd": 10}
    got = {k: train_launches[k] for k in want}
    check(got == {k: v * TRAIN_STEPS for k, v in want.items()},
          f"gin-tu/ogb_products: K7 launches {got} in {TRAIN_STEPS} steps, expected "
          f"{want} a step")
    edges = batch["edges"]
    del runs, p0, batch
    torch.cuda.empty_cache()
    time_k7_train(torch, rows, train_launches, edges, shape.n_nodes, d)
    del edges
    torch.cuda.empty_cache()

    out["launcher"] = train_launcher_round_trip(np)
    log("training " + json.dumps({k: v for k, v in out.items() if k != "card"}))
    return rows


# ------------------------------------------------------------- phase 15
# The dry run (``repro_torch.launch.dryrun``, ``launch/op_analysis.py``):
# each kernel entry's abstract rule against its launch, the training runs'
# peaks predicted by a dry step on fake CUDA tensors, and the CLI on fake
# CUDA against fake CPU tensors. A predicted peak is what was allocated
# before the run, less the run's parameters and batch, plus the dry step's
# peak of live bytes (its parameters, optimizer state and batch included);
# the gate holds it within DRY_PEAK_TOL of ``max_memory_allocated``. The
# training phase's one-card runs (``full_run``) leave their recipes in
# TRAIN_RUNS; a second run of the same configuration (gin-tu's run 2) is
# not predicted again.
DRY_PEAK_TOL = 0.2
DRY_CLI_CELLS = (("biggraphvis", "layout_livejournal", "single"),
                 ("gin-tu", "full_graph_sm", "multi"))
DRY_CLI_TIMEOUT = 120
TRAIN_RUNS: list = []


def _shapes(tree):
    from repro_torch.models.param import tree_map

    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def _shape_bytes(torch, tree) -> int:
    from repro_torch.models.param import tree_leaves

    return sum(math.prod(sh) * torch.empty((), dtype=dt).element_size()
               for sh, dt in tree_leaves(tree))


def rule_entries(torch, dev):
    """Every kernel entry with an abstract rule, called on small seeded
    inputs on ``dev``: (entry, inputs, call on a dict of inputs)."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.segment import ops as seg_ops

    g = torch.Generator(device=dev).manual_seed(SEED)
    n, e = 3000, 20000
    t = {"pos": torch.randn((n, 2), generator=g, device=dev) * 10,
         "mass": torch.rand(n, generator=g, device=dev) + 1,
         "radii": torch.rand(n, generator=g, device=dev),
         "src": torch.sort(torch.randint(0, n + 1, (e,), generator=g, device=dev,
                                         dtype=torch.int32)).values,
         "dst": torch.randint(0, n + 1, (e,), generator=g, device=dev, dtype=torch.int32),
         "w": torch.rand(e, generator=g, device=dev),
         "data": torch.randn((e, 5), generator=g, device=dev),
         "keys": torch.randint(-1, 500, (e,), generator=g, device=dev, dtype=torch.int32)}
    cell, order = grid_ops.bin_and_sort(t["pos"], 16)
    idx = order.long()
    t["pos_s"], t["mass_s"], t["cell_s"] = t["pos"][idx], t["mass"][idx], cell[idx]
    t["ccent"], t["cmass"] = grid_ops.cell_stats(t["pos_s"], t["mass_s"], t["cell_s"], 256)
    cfg = cms_lib.CMSConfig(rows=4, cols=337)

    def gather_bwd(x, idx):
        x = x.detach().requires_grad_(True)
        seg_ops.gather_rows(x, idx).sum().backward()
        return x.grad

    return t, {
        "repulsion_nbody": lambda t: rep_ops.repulsion(t["pos"], t["mass"], 1.5,
                                                       radii=t["radii"]),
        "repulsion_rows": lambda t: rep_ops.repulsion_rows(t["pos"], t["mass"], 1000, 1500, 1.5,
                                                           radii=t["radii"]),
        "segment_offsets": lambda t: seg_ops.segment_offsets(t["src"], n),
        "segment_sum": lambda t: seg_ops.segment_sum(t["data"], t["dst"], n),
        "attraction_sum": lambda t: seg_ops.attraction_sum(
            t["pos"], t["dst"], t["w"], seg_ops.segment_layout(t["src"], n, sorted=True)),
        "segment_sum_edges": lambda t: seg_ops.segment_sum_edges(t["data"], t["dst"], n),
        "segment_sum_gather_bwd": lambda t: gather_bwd(t["pos"], t["dst"]),
        "cms_update_keys": lambda t: cms_ops.update(
            torch.zeros((4, 337), device=t["w"].device), t["keys"], t["w"], cfg),
        "cms_update": lambda t: cms_ops.update_hashed(
            torch.zeros((4, 337), device=t["w"].device), cms_ops.hashed_buckets(t["keys"], cfg),
            t["w"]),
        "far_field": lambda t: grid_ops.far_field(t["pos_s"], t["mass_s"], t["cell_s"],
                                                  t["ccent"], t["cmass"], 80.0),
        "near_field": lambda t: grid_ops.near_field_sorted(t["pos_s"], t["mass_s"],
                                                           t["cell_s"], 80.0, 32),
        "near_field_rows": lambda t: grid_ops.near_field_rows(
            t["pos_s"], t["mass_s"], t["cell_s"], 80.0, 32, 1000, 1500),
    }


def rule_checks(torch) -> None:
    """Gate (a): each rule's output (shape, dtype, strides) that of one real
    launch at the same shapes; the fake call launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build

    inputs, entries = rule_entries(torch, "cuda")
    for name, fn in entries.items():
        before = dict(build.LAUNCHES)
        real = fn(inputs)
        torch.cuda.synchronize()
        check(build.LAUNCHES[name] == before[name] + 1, f"{name}: the real call did not launch")
        mode = FakeTensorMode()
        before = dict(build.LAUNCHES)
        with mode:
            fake = fn({k: mode.from_tensor(v) for k, v in inputs.items()})
        check(build.LAUNCHES == before, f"{name}: the abstract rule launched a kernel")
        got = (tuple(fake.shape), fake.dtype, fake.stride(), fake.device)
        want = (tuple(real.shape), real.dtype, real.stride(), real.device)
        log(f"dry run rule {name}: fake {got}, launch {want}")
        check(got == want, f"{name}: the abstract rule gives {got}, the launch {want}")


def grid_step_rule_check(torch, np) -> dict:
    """Gate (a) on a whole step: the grid form of ``layout_livejournal``
    (K5–K7, ``_mesh_bgv_inputs``' seeded supergraph stand-in) run once on
    the card with its launches counted, then traced on fake CUDA tensors of
    the same inputs: each kernel entry's rule calls equal to its launches,
    the outputs' metadata equal, K5's operations and bytes its bound
    arithmetic (``far_field_cost``) and K6's the same with every in-range
    band slot a same-cell pair (a rule cannot read the cells; the pairs this
    input holds are logged beside it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import build
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.steps import build_step

    arch, shape, args = _mesh_bgv_inputs(torch, np, "layout_livejournal+grid", "grid")
    built = build_step(arch, shape)
    for c in build.LAUNCHES:
        build.LAUNCHES[c] = 0
    real = built.fn(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    mode = FakeTensorMode()
    with mode:
        fake_args = [mode.from_tensor(a) for a in args]
        with OpCounter() as counter:
            fake = built.fn(*fake_args)
    check(build.LAUNCHES == {**dict.fromkeys(build.LAUNCHES, 0), **launches},
          "the grid step's rules launched a kernel")
    rules = counter.stats.kernels
    calls = {k: v["calls"] for k, v in rules.items()}
    log(f"dry run grid step {shape.name}: rule calls {calls}, launches {launches}")
    check(calls == launches, f"grid step: rule calls {calls}, launches {launches}")
    meta = [(tuple(x.shape), x.dtype, x.stride(), x.device) for x in real]
    check(meta == [(tuple(x.shape), x.dtype, x.stride(), x.device) for x in fake],
          "grid step: the traced outputs differ in shape, dtype, strides or device")
    n, c, w = shape.n_nodes, arch.model.layout_grid_size ** 2, arch.model.layout_grid_window
    k5, k6 = grid_ops.far_field_cost(n, c), grid_ops.near_field_cost(n, w)
    check((rules["far_field"]["operations"], rules["far_field"]["bytes"]) == k5,
          f"grid step: K5's rule counted {rules['far_field']}, its bound arithmetic {k5}")
    check((rules["near_field"]["operations"], rules["near_field"]["bytes"]) == k6,
          f"grid step: K6's rule counted {rules['near_field']}, its bound arithmetic {k6}")
    cell, order = args[-2:]
    cell_s = cell[order.long()]
    pairs = sum(2 * int((cell_s[k:] == cell_s[:-k]).sum()) for k in range(1, min(w, n - 1) + 1))
    out = {"rule_calls": calls, "launches": launches, "far_field": rules["far_field"],
           "near_field": rules["near_field"], "same_cell_pairs": pairs,
           "near_field_ops_at_pairs": grid_ops.near_field_cost(n, w, pairs)[0]}
    log("dry run grid step " + json.dumps(out))
    return out


def predicted_peak(run) -> tuple:
    """A training run's predicted peak bytes (the phase's comment), the dry
    step's ``OpStats`` and its seconds: one step of ``make_train_step`` at
    the run's configuration on fake CUDA tensors of its parameters' and
    batch's shapes. Runs in a worker process of its own."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models.param import tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=run["lr"], state_bits=run["bits"]),
                       microbatch=run["microbatch"])

    def make():
        params = tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="cuda"),
                          run["params"])
        batch = tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="cuda"),
                         run["batch"])
        return params, opt.init_opt_state(params, tcfg.adamw), batch

    stats, seconds = dryrun.trace(make_train_step(run["loss_fn"], tcfg), make)
    other = run["before"] - _shape_bytes(torch, run["params"]) - _shape_bytes(torch, run["batch"])
    return other + stats.peak_bytes, stats, seconds


def dry_cli(env, out_dir):
    """Start the dry run's CLI on DRY_CLI_CELLS, on fake CUDA tensors (the
    default) and on fake CPU tensors, each device its own directory."""
    procs = []
    for arch, shape, mesh in DRY_CLI_CELLS:
        for dev in ("cuda", "cpu"):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                   shape, "--mesh", mesh, "--out", str(Path(out_dir) / dev), "--force"]
            # Niced: the phase waits on the peak predictions first.
            procs.append(subprocess.Popen(cmd + (["--device", "cpu"] if dev == "cpu" else []),
                                          env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True,
                                          preexec_fn=lambda: os.nice(10)))
    return procs


def dry_run_smoke_phase(torch, np, smi: str) -> dict:
    """The ``dry run`` phase: gates (a) ``rule_checks``, (b) every training
    run's peak predicted within DRY_PEAK_TOL, (c) the CLI's records on fake
    CUDA and fake CPU tensors equal but for ``trace_s``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    out = {"card": smi}
    runs = [run for run in TRAIN_RUNS if "run 2" not in run["name"]]
    check(bool(runs), "dry run: the training phase left no run to predict")
    # The workers (spawned: this process holds the card) unpickle the
    # recipes' loss functions, so they need the port on their path.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = env["PYTHONPATH"]
    # The LMs' dry steps (tens of seconds each) in worker processes, the
    # others (a few seconds) here while the workers run.
    heavy = [run for run in runs if run["kind"] == "lm"]
    with (tempfile.TemporaryDirectory() as tmp,
          ProcessPoolExecutor(max(1, len(heavy)),
                              mp_context=multiprocessing.get_context("spawn")) as pool):
        t0 = time.perf_counter()
        futures = {run["name"]: pool.submit(predicted_peak, run) for run in heavy}
        procs = dry_cli(env, tmp)
        try:
            rule_checks(torch)
            out["grid_step"] = grid_step_rule_check(torch, np)
            results = {run["name"]: predicted_peak(run)
                       for run in runs if run["kind"] != "lm"}
            log(f"dry run: rules and the in-process predictions done at "
                f"{time.perf_counter() - t0:.3f} s")
            for run in runs:
                pred, stats, seconds = (results[run["name"]] if run["name"] in results
                                        else futures[run["name"]].result())
                rec = {"predicted_bytes": pred, "measured_bytes": run["peak"],
                       "relative": pred / run["peak"] - 1,
                       "dry_step_peak_bytes": stats.peak_bytes,
                       "allocated_before": run["before"], "trace_s": seconds,
                       "kernels": stats.kernels}
                if run["kind"] == "lm":
                    rec["lm_train_estimate"] = run["estimate"]
                out[run["name"]] = rec
                log(f"dry run {run['name']} (at {time.perf_counter() - t0:.3f} s): "
                    + json.dumps(rec))
            for run in runs:  # every prediction printed first, then the gate
                rel = out[run["name"]]["relative"]
                check(abs(rel) <= DRY_PEAK_TOL,
                      f"{run['name']}: predicted peak {out[run['name']]['predicted_bytes']} "
                      f"bytes, measured {run['peak']} ({rel:+.3f}; limit {DRY_PEAK_TOL})")
            for p in procs:
                log_text, _ = p.communicate(timeout=DRY_CLI_TIMEOUT)
                check(p.returncode == 0, f"dry run CLI {p.args}: exit {p.returncode}\n"
                                         + log_text[-3000:])
            log(f"dry run: the CLI runs done at {time.perf_counter() - t0:.3f} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            if saved is None:
                os.environ.pop("PYTHONPATH")
            else:
                os.environ["PYTHONPATH"] = saved
        for arch, shape, mesh in DRY_CLI_CELLS:
            name = f"{arch}__{shape}__{mesh}.json"
            recs = []
            for dev in ("cuda", "cpu"):
                rec = json.loads((Path(tmp) / dev / name).read_text())
                out[f"{name} trace_s {dev}"] = rec.pop("trace_s")
                recs.append(rec)
            log(f"dry run CLI {name}: " + json.dumps(recs[0]))
            check(recs[0]["status"] == "ok", f"{name}: {recs[0].get('error')}")
            check(recs[0] == recs[1], f"{name}: fake CUDA and fake CPU records differ")
    log("dry run " + json.dumps({k: v for k, v in out.items() if k != "card"}, default=str))
    return out


# ------------------------------------------------------------- phase 16
# The model mesh: the training cells and the BigGraphVis cells on
# MESH_RANKS ranks of one process each, sharing the card under gloo
# (``launch.steps.build_step(..., mesh)``), each held against the same
# cell's one-rank step on the card. The LMs run in float32 (the gate is
# TRAIN_TOL["lm"], measured with float32 activations) at LM_LR, yi-6b at
# the deepest depth whose estimate (``mesh_lm_estimate``: the two ranks
# together, then rank 0's one-rank step beside the gathered parameters)
# stays under MESH_BUDGET bytes, at most MESH_TP_LAYERS: 8 layers fit, but
# their two steps took 9.1 and 20.8 s on a slow host (H100 80GB HBM3,
# 700.00 W, PERF.md §6; 4.3–4.6 s on a faster one, PERF.md §5), and the
# tensor-parallel split is the same at 4. gin-tu runs MESH_GNN_CELL, twice from the
# same parameters: on ogbn-products' counts a 2-rank step took 26.1–37.1 s
# (30 all-reduces of a [2.45 M, 64] float32 partial a step through the
# host, 53–70 s of collectives a 2-step run; H100 80GB HBM3, 700.00 W,
# PERF.md §6), which puts the phase far past its 150 s aim even at
# one step, so it runs gin-tu's ``full_graph_sm`` (Cora's counts).
MESH_RANKS, MESH_BUDGET, MESH_TIMEOUT, MESH_STEPS = 2, 60e9, 900, 2
MESH_TP_LAYERS = 4
MESH_GNN_CELL = "full_graph_sm"
# gin-tu on 2 ranks against one, after MESH_STEPS steps: (loss, grad norm,
# parameters of max|p|), about 3× the measured 2.76e-7, 3.93e-7 and
# 1.92e-5 (in_w, 0.0026·lr; H100 80GB HBM3, 700.00 W, PERF.md §6).
# Not TRAIN_TOL["gnn"], which was measured card against CPU on gin-tu's
# molecule and gat-cora: here each node's message sum is two chains, one a
# rank, and their sum, where one rank adds one chain; Cora-sized GIN
# gradients (norm 1.5e4) carry that difference further.
MESH_GNN_TOL = (1e-6, 1.5e-6, 6e-5)
# graphcast's MESH_GNN_CELL at MESH_GRAPHCAST_LAYERS layers on (2, 1), one
# step, against its one-rank step: (loss, grad norm, share of parameter
# elements off by more than 1e-6·max|p| + 2e-3·lr, the CPU tests' step
# tolerance), every element also within AdamW's reach of 2.02·lr. A
# parameter is not held to a max: the sparse 0/1 features leave a few
# elements with gradients near 1e-9, whose sign the two sums' rounding
# decides, and AdamW's first step moves such an element by ≈ lr either way
# (in_w 1.37·lr apart on the card after 2 steps, H100 80GB HBM3, 700.00 W,
# PERF.md §6). Over a second step that flip moves 2.3 % of the elements apart
# by more than the step tolerance (the same card run), so the run takes
# one step, where only such elements differ. One step on the card read a
# loss equal to the one-rank step's, the grad norm 1.33e-7 off and
# 1.39e-4 of the 5.0 M elements off (in_w 1.366·lr); the tolerances are
# gin-tu's loss tolerance and about 3× the other two readings.
MESH_GRAPHCAST_LAYERS = 2
MESH_GRAPHCAST_TOL = (1e-6, 4e-7, 4e-4)
# (run, arch, mesh shape, rows × sequence, layers or None for the arch's,
# compress_grads, microbatches, SP pair). The sequence divides over "model",
# so the runs on (1, 2) split it (sequence parallelism, build_step's rule);
# an SP pair runs a second time with ``seq_axis`` None, and the two are
# compared bit for bit. The microbatched run (fault F3 on the card) takes a
# ragged loss mask (MESH_MASK_KEEP of the positions), so that which rows
# share a microbatch changes its loss, and one step: the first step's loss
# and gradients show which rows shared a microbatch, and its two steps
# took 73 s of the phase on a slow host (H100 80GB HBM3, 700.00 W,
# PERF.md §6).
MESH_LM_RUNS = (("yi-6b-tp", "yi-6b", (1, 2), (1, 4096), None, False, 0, False),
                ("granite-moe-ep-tp", "granite-moe-1b-a400m", (1, 2), (2, 4096), 2, False, 0,
                 False),
                ("yi-6b-dp-zero-compress", "yi-6b", (2, 1), (2, 4096), 2, True, 0, False),
                ("yi-6b-sp-on-off", "yi-6b", (1, 2), (1, 4096), 2, False, 0, True),
                ("yi-6b-dp-microbatch", "yi-6b", (2, 1), (4, 4096), 2, False, 2, False))
MESH_MASK_KEEP = 0.6
MESH_BGV_CELLS = (("detect_berkstan", None), ("detect_livejournal", None),
                  ("layout_berkstan", "exact"), ("layout_livejournal", "exact"),
                  ("layout_livejournal+grid", "grid"))
MESH_COUNTERS = ("segment_offsets", "segment_sum_edges", "segment_sum_gather_bwd",
                 "attraction_sum", "segment_sum", "cms_update_keys", "repulsion_rows",
                 "repulsion_nbody", "near_field_rows", "near_field", "far_field")


def _mesh_local_bytes(built, mesh) -> tuple:
    """(sum over ranks of the parameters' block elements, the whole
    parameters' elements) of a built step's specs."""
    import math

    from repro_torch.models.param import tree_leaves

    total = split = 0
    for spec, a in zip(tree_leaves(built.in_specs[0]), tree_leaves(built.abstract_args[0])):
        n = math.prod(a.shape)
        k = 1
        for e in spec:
            k *= mesh.extent(e if isinstance(e, tuple) else ((e,) if e else ()))
        total += n
        split += n // k * mesh.size
    return split, total


def mesh_lm_estimate(torch, cfg, rows: int, seq: int, shape) -> tuple:
    """Device bytes of an LM train step on a (data, model) mesh of
    ``shape`` sharing one card: ``(the ranks together, rank 0's one-rank
    step beside the gathered parameters)``. A rank: its parameter blocks
    with their gradients and float32 AdamW state (16 B an element), each
    layer's saved input (remat), one layer's attention over its heads
    (float32 scores and softmax), its MLP share, its vocab share of the
    float32 logits with their gradient, and the whole parameters while they
    are made and cut (4 B an element)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.launch.steps import build_step

    arch = dataclasses.replace(get_config("yi-6b" if cfg.moe is None else
                                          "granite-moe-1b-a400m"), model=cfg)
    mesh = ModelMesh(("data", "model"), {"data": shape[0], "model": shape[1]}, 0,
                     {"data": 0, "model": 0}, torch.device("cpu"), {})
    built = build_step(arch, ShapeSpec("train_4k", "train", seq_len=seq, global_batch=rows), mesh)
    split, total = _mesh_local_bytes(built, mesh)
    d, m = shape
    t = rows * seq // d
    ff = cfg.d_ff if cfg.moe is None else int(cfg.moe.top_k * cfg.moe.capacity_factor
                                             * cfg.moe.d_ff_expert)
    act = (cfg.n_layers * t * cfg.d_model * 4 + rows // d * cfg.n_heads // m * seq * seq * 8
           + 6 * t * ff // m * 4 + 4 * t * cfg.vocab_padded // m * 4)
    ranks = split * 16 + d * m * act + d * m * total * 4
    one = total * 16 + m * d * act + total * 4
    return ranks, one


def _flat_names(tree, prefix=""):
    """The ``/``-joined paths of a nested dict's leaves."""
    if isinstance(tree, dict):
        return [n for k in tree for n in _flat_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _tree_same(torch, a, b) -> bool:
    from repro_torch.models.param import tree_leaves

    return all(bits_equal(torch, x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _mesh_lm_setup(torch, run, depth):
    """``(arch, cfg, shape spec, loss, params (whole, seeded), batches,
    tcfg)`` of an LM run of MESH_LM_RUNS, the same on every rank."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import LMStream
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig

    _, arch_name, _, (rows, seq), layers, compress, micro, _ = run
    arch = get_config(arch_name)
    cfg = dataclasses.replace(arch.model, n_layers=layers or depth, act_dtype=torch.float32)
    arch = dataclasses.replace(arch, model=cfg)
    spec = ShapeSpec("train_4k", "train", seq_len=seq, global_batch=rows)
    stream = LMStream(cfg.vocab, rows, seq, seed=SEED)
    batches = [stream.batch_at(i) for i in range(1 if micro else MESH_STEPS)]
    if micro:
        rng = np.random.default_rng(SEED)
        for b in batches:
            b["loss_mask"] = b["loss_mask"] * (rng.random(b["loss_mask"].shape) < MESH_MASK_KEEP)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()} for b in batches]
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=LM_LR, state_bits=arch.opt_state_bits),
                       compress_grads=compress, microbatch=micro)
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    return arch, cfg, spec, tfm.lm_loss, params, batches, tcfg


def _mesh_other_setup(torch, name):
    """SASRec's train_batch, gin-tu's MESH_GNN_CELL and graphcast's at
    MESH_GRAPHCAST_LAYERS layers, as ``_mesh_lm_setup``."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.data.pipeline import SASRecStream
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.models import sasrec as sas_lib
    from repro_torch.models.param import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig

    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=LR))
    if name == "sasrec":
        arch = get_config("sasrec")
        cfg, spec = arch.model, arch.shapes["train_batch"]
        stream = SASRecStream(cfg.n_items, spec.global_batch, cfg.seq_len, seed=SEED)
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in stream.batch_at(i).items()}
                   for i in range(MESH_STEPS)]
        params = sasrec_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
        return arch, cfg, spec, sas_lib.sasrec_loss, params, batches, tcfg
    import numpy as np

    arch, spec, cfg, host = gnn_cell_batch(np, "gin-tu" if name == "gin" else name,
                                           MESH_GNN_CELL)
    if name == "graphcast":
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=MESH_GRAPHCAST_LAYERS))
        cfg = arch.model_for(spec)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    params = init_params(prng.key(SEED), gnn_lib.param_specs(cfg), device="cuda")
    steps = 1 if name == "graphcast" else MESH_STEPS
    return arch, cfg, spec, gnn_lib.gnn_loss, params, [batch] * steps, tcfg


class _CollectiveClock:
    """Host seconds inside ``torch.distributed``'s all_reduce and
    all_gather (gloo waits for the data), while installed."""

    def __init__(self, dist):
        self.dist, self.seconds, self.calls = dist, 0.0, 0
        self.saved = {k: getattr(dist, k) for k in ("all_reduce", "all_gather")}
        for k, fn in self.saved.items():
            setattr(dist, k, self._timed(fn))

    def _timed(self, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return call

    def remove(self):
        for k, fn in self.saved.items():
            setattr(self.dist, k, fn)


def _mesh_train_run(torch, mesh, setup, name: str, runs: int = 1, sp_pair: bool = False) -> dict:
    """A training run on ``mesh``: ``runs`` times from the same seeded
    parameters, each rank on its blocks; every rank's launches, step ms,
    peak bytes and collective seconds, and (rank 0) the gathered
    parameters against the one-rank step on the card and the runs against
    each other, bitwise. ``sp_pair``: the second run with the sequence
    unsplit (``seq_axis`` None)."""
    import functools as ft

    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.steps import build_step
    from repro_torch.models.param import tree_leaves
    from repro_torch.sharding.params import gather_tree, shard_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import make_train_step

    arch, cfg, spec, loss, params, batches, tcfg = setup
    built = build_step(dataclasses.replace(arch, opt_state_bits=tcfg.adamw.state_bits), spec, mesh)
    p_specs, o_specs, b_specs = built.in_specs
    places = [built.place] * runs
    if sp_pair:
        places = [built.place, dataclasses.replace(built.place, seq_axis=None)]
        runs = 2
    local_batches = [shard_tree(b, b_specs, mesh) for b in batches]
    info = {"run": name, "rank": mesh.rank, "mesh": dict(mesh.shape),
            "batch_axes": list(built.place.batch_axes), "runs": [],
            "seq_axis": [p.seq_axis if p.sp else None for p in places],
            "microbatch": tcfg.microbatch}
    t_run = time.perf_counter()
    if hasattr(cfg, "remat"):  # a GNN: the rank's block of node rows
        from repro_torch.sharding.collectives import block_range

        info["node_rows"] = block_range(spec.n_nodes, mesh.size, mesh.index(mesh.axis_names))
    finals = []
    for k in range(runs):
        step = make_train_step(ft.partial(loss, cfg, place=places[k]), tcfg, mesh=places[k])
        lp = shard_tree(params, p_specs, mesh)
        state = opt.init_opt_state(lp, tcfg.adamw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        for c in build.LAUNCHES:
            build.LAUNCHES[c] = 0
        clock = _CollectiveClock(dist)
        metrics, ms = [], []
        try:
            for b in local_batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lp, state, m = step(lp, state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            clock.remove()
        info["runs"].append({
            "losses": [x[0] for x in metrics], "grad_norms": [x[1] for x in metrics],
            "step_ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
            "allocated_before": before,
            "collective_s": clock.seconds, "collectives": clock.calls,
            "launches": {c: build.LAUNCHES[c] for c in MESH_COUNTERS if build.LAUNCHES[c]}})
        del state
        finals.append(gather_tree(lp, p_specs, mesh) if mesh.rank == 0 else None)
        if mesh.rank != 0:
            gather_tree(lp, p_specs, mesh)
        del lp
        torch.cuda.empty_cache()
    local_batches = setup = None
    if mesh.rank != 0:
        del params, batches
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        if runs > 1:
            info["sp_on_off_bitwise" if sp_pair else "ranks_run_to_run_bitwise"] = _tree_same(
                torch, finals[0], finals[1])
        if not sp_pair:
            del finals[1:]
        one = make_train_step(ft.partial(loss, cfg), tcfg)
        p1, params = params, None  # the step updates it in place
        st = opt.init_opt_state(p1, tcfg.adamw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        info["one_rank_allocated_before"] = torch.cuda.memory_allocated()
        m1, t0 = [], time.perf_counter()
        for b in batches:
            p1, st, m = one(p1, st, b)
            m1.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        info["one_rank_s"] = time.perf_counter() - t0
        info["one_rank_peak_bytes"] = torch.cuda.max_memory_allocated()
        del st
        mine = info["runs"][0]
        info["one_rank_losses"] = [x[0] for x in m1]
        info["loss_rel"] = max(abs(a / x[0] - 1) for a, x in zip(mine["losses"], m1))
        info["grad_norm_rel"] = max(abs(a / x[1] - 1) for a, x in zip(mine["grad_norms"], m1))
        info["param_max_rel"] = _max_rel(torch, finals[0], p1)
        if "node_rows" in info:  # the GNNs' gate (MESH_GRAPHCAST_TOL)
            info["param_off_share"], info["param_within_reach"] = _flip_share(
                torch, finals[0], p1, tcfg.adamw.lr, len(batches))
        if sp_pair:
            info["sp_off_param_max_rel"] = _max_rel(torch, finals[1], p1)
            m_off = info["runs"][1]
            info["sp_off_loss_rel"] = max(abs(a / x[0] - 1) for a, x in zip(m_off["losses"], m1))
            info["sp_off_grad_norm_rel"] = max(abs(a / x[1] - 1)
                                               for a, x in zip(m_off["grad_norms"], m1))
        names = sorted(_flat_names(p1))
        worst = max((float((x - y).abs().max()) / tcfg.adamw.lr, k) for k, x, y in zip(
            names, tree_leaves(finals[0]), tree_leaves(p1)))
        info["param_max_abs_over_lr"], info["worst_leaf"] = worst
        del p1, finals
    torch.cuda.empty_cache()
    dist.barrier()
    info["run_s"] = time.perf_counter() - t_run
    return info


def _mesh_bgv_inputs(torch, np, name: str, model):
    """A BigGraphVis cell's step inputs at its padded shape, the same on
    every rank: detect on a graph of the cell's real counts made on the
    card (``_lj_graph``), layout on ``dry_run_phase``'s seeded supergraph
    stand-ins."""
    from repro_torch.configs import get_config
    from repro_torch.configs.biggraphvis import BGVDryConfig
    from repro_torch.kernels.grid import ops as grid_ops

    arch = get_config("biggraphvis")
    shape = arch.shapes[name.split("+")[0]]
    n, e = shape.n_nodes, shape.n_edges
    if shape.kind == "bgv_detect":
        real = {"detect_berkstan": (685_230, 6_649_470),
                "detect_livejournal": (LJ_NODES, LJ_EDGES)}[name]
        ed = _padded(torch, _lj_graph(torch, *real), e, n)
        com0 = torch.arange(n + 1, dtype=torch.int32, device="cuda")
        deg0 = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
        return arch, shape, (com0, deg0, ed)
    model = BGVDryConfig(layout_repulsion=model, layout_grid_size=GRID, layout_grid_window=WINDOW)
    arch = dataclasses.replace(arch, model=model)
    real_n, real_e = LAYOUT_REAL[shape.name]
    rng = np.random.default_rng(SEED)
    pos = rng.uniform(-1000, 1000, (n, 2)).astype(np.float32)
    mass = rng.integers(1, 200, n).astype(np.float32)
    ed = np.full((e, 2), n, np.int32)
    ed[:real_e] = rng.integers(0, real_n, (real_e, 2))
    w = rng.integers(1, 20, e).astype(np.float32)
    args = [torch.as_tensor(x, device="cuda")
            for x in (pos, np.zeros_like(pos), mass, np.sqrt(mass), ed, w)]
    if model.layout_repulsion == "grid":
        args += list(grid_ops.bin_and_sort(args[0], GRID))
    return arch, shape, tuple(args)


def _mesh_bgv_run(torch, np, mesh, name: str, model) -> dict:
    """A BigGraphVis cell on ``mesh``: the rank's blocks through the sharded
    step, the outputs gathered, and (rank 0) held bitwise against the
    one-rank step on the card; launches, step ms and collective seconds."""
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.params import gather_tree, shard_tree

    arch, shape, args = _mesh_bgv_inputs(torch, np, name, model)
    built = build_step(arch, shape, mesh)
    local = [shard_tree(a, s, mesh) for a, s in zip(args, built.in_specs)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in build.LAUNCHES:
        build.LAUNCHES[c] = 0
    clock = _CollectiveClock(dist)
    try:
        t0 = time.perf_counter()
        outs = built.fn(*local)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        clock.remove()
    info = {"run": name, "rank": mesh.rank, "step_ms": ms, "collective_s": clock.seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": {c: build.LAUNCHES[c] for c in MESH_COUNTERS if build.LAUNCHES[c]}}
    if shape.kind == "bgv_layout":
        outs = [gather_tree(o, built.in_specs[0], mesh) for o in outs]
    if mesh.rank == 0:
        one = build_step(arch, shape).fn(*args)
        info["bitwise"] = _same(torch, outs, one)
    del local, outs, args
    torch.cuda.empty_cache()
    dist.barrier()
    return info


def mesh_rank(_stream_mesh, out_dir: str, depth: int) -> None:
    """One rank of the model mesh phase (spawned by ``model_mesh_phase``):
    every run of MESH_LM_RUNS, SASRec on (1, 2), gin-tu's MESH_GNN_CELL on
    (2, 1) twice, graphcast's at MESH_GRAPHCAST_LAYERS layers on (2, 1), and
    MESH_BGV_CELLS on (1, 2); writes ``out_dir/rank{r}.json``."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_model_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_model_mesh(shape, ("data", "model"), backend="gloo")
        return meshes[shape]

    out = []
    for run in MESH_LM_RUNS:
        out.append(_mesh_train_run(torch, mesh_of(run[2]), _mesh_lm_setup(torch, run, depth),
                                   run[0], sp_pair=run[7]))
    out.append(_mesh_train_run(torch, mesh_of((1, 2)), _mesh_other_setup(torch, "sasrec"),
                               "sasrec-vocab"))
    out.append(_mesh_train_run(torch, mesh_of((2, 1)), _mesh_other_setup(torch, "gin"),
                               f"gin-tu-{MESH_GNN_CELL}-nodes", runs=2))
    out.append(_mesh_train_run(torch, mesh_of((2, 1)), _mesh_other_setup(torch, "graphcast"),
                               f"graphcast-{MESH_GNN_CELL}-nodes"))
    for name, model in MESH_BGV_CELLS:
        out.append(_mesh_bgv_run(torch, np, mesh_of((1, 2)), name, model))
    with open(os.path.join(out_dir, f"rank{_stream_mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def model_mesh_phase(torch, np, smi: str) -> dict:
    """The training mesh and the BigGraphVis cells on MESH_RANKS ranks
    sharing the card under gloo (``mesh_rank``):

    * yi-6b ``train_4k`` at full width on (1, 2), tensor and sequence
      parallel, at the depth MESH_BUDGET allows (at most MESH_TP_LAYERS),
      one 4,096-token row; granite-moe at full width and 2 layers on (1,
      2), experts and tensors parallel, 2 × 4,096 tokens; yi-6b at 2
      layers on (2, 1), data parallel with d_model's ZeRO-3 split and
      ``compress_grads``, 2 rows; yi-6b at 2 layers on (1, 2) with the
      sequence split and again unsplit; yi-6b at 2 layers on (2, 1) with 2
      microbatches of 4 rows and a ragged loss mask (fault F3), one step;
      float32, MESH_STEPS steps each but that one;
    * SASRec ``train_batch`` uncut on (1, 2) (the item table split);
    * gin-tu's MESH_GNN_CELL (``full_graph_sm``: ``ogb_products`` took
      26–37 s a step here) on (2, 1), twice from the same parameters, and
      graphcast's at MESH_GRAPHCAST_LAYERS layers on (2, 1), one step: the edges
      split, and the node state each rank's block of rows;
    * the four ``bgv_*`` cells at their padded shapes and a grid variant
      of ``layout_livejournal`` on (1, 2).
    Gates: every run's gathered parameters (outputs for the BigGraphVis
    cells) against the same cell's one-rank step on the card: the LMs and
    SASRec within TRAIN_TOL[family], gin-tu within MESH_GNN_TOL and its two
    runs bitwise, graphcast within MESH_GRAPHCAST_TOL (its parameters by
    the share of elements off), the BigGraphVis
    cells bitwise, the SP pair's unsplit run within TRAIN_TOL too (whether
    the two were bitwise is logged); each run's kernels launched on every
    rank. Prints each rank's launches, step ms, peak bytes and collective
    seconds, and for the GNNs each rank's block of node rows and peak
    bytes beside the one-rank step's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_local

    yi = get_config("yi-6b").model
    rows, seq = MESH_LM_RUNS[0][3]
    shape = MESH_LM_RUNS[0][2]
    fits = [n for n in range(1, yi.n_layers + 1)
            if max(mesh_lm_estimate(torch, dataclasses.replace(yi, n_layers=n), rows, seq,
                                    shape)) <= MESH_BUDGET]
    depth = min(max(fits), MESH_TP_LAYERS)
    est = mesh_lm_estimate(torch, dataclasses.replace(yi, n_layers=depth), rows, seq, shape)
    log(f"model mesh: yi-6b on {shape} at {depth} of {yi.n_layers} layers; estimate "
        f"{est[0]} bytes on the two ranks, {est[1]} for the one-rank step")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_local(mesh_rank, MESH_RANKS, backend="gloo", init_file=str(Path(tmp) / "store"),
                    args=(tmp, depth), timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    out = {"card": smi, "wall_s": wall, "yi_layers": depth, "runs": {}}
    log(f"model mesh: {wall:.3f} s for the spawned ranks ({smi}); each run's seconds "
        + json.dumps({r["run"]: round(r.get("run_s", r.get("step_ms", 0) / 1e3), 3)
                      for r in ranks[0]}))
    failed = []  # every gate is read before any fails the phase

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    for lead, *rest in zip(*ranks):
        name = lead["run"]
        out["runs"][name] = [lead, *rest]
        log(f"model mesh {name} " + json.dumps([lead, *rest]))
        for r in [lead, *rest]:
            launches = r["launches"] if "launches" in r else r["runs"][0]["launches"]
            want = _mesh_kernels(name)
            gate(all(launches.get(k, 0) > 0 for k in want),
                 f"{name}: rank {r['rank']} launched {launches}, expected {want}")
        if name.startswith(("detect", "layout")):
            gate(lead["bitwise"], f"{name}: 2 ranks differ from one")
            continue
        family = "lm" if name.startswith(("yi", "granite")) else (
            "sasrec" if name.startswith("sasrec") else "gnn")
        tol_loss, tol_gnorm, tol_p = (
            MESH_GRAPHCAST_TOL if name.startswith("graphcast") else
            MESH_GNN_TOL if family == "gnn" else TRAIN_TOL[family])
        if family == "gnn":
            log(f"model mesh {name}: " + "; ".join(
                f"rank {r['rank']} node rows {r['node_rows']}, peak "
                f"{r['runs'][0]['peak_bytes']} bytes ({r['runs'][0]['allocated_before']} "
                "allocated before)" for r in [lead, *rest])
                + f"; one rank: peak {lead['one_rank_peak_bytes']} bytes "
                f"({lead['one_rank_allocated_before']} allocated before)")
        gate(lead["loss_rel"] <= tol_loss and lead["grad_norm_rel"] <= tol_gnorm,
             f"{name}: loss or grad norm {lead['loss_rel']}, {lead['grad_norm_rel']} off "
             "the one-rank step")
        if name.startswith("graphcast"):
            gate(lead["param_off_share"] <= tol_p and lead["param_within_reach"],
                 f"{name}: {lead['param_off_share']} of the parameters off the one-rank "
                 f"step, all within AdamW's reach: {lead['param_within_reach']}")
        else:
            gate(lead["param_max_rel"] <= tol_p,
                 f"{name}: parameters {lead['param_max_rel']} of max|p| off the one-rank step")
        if "ranks_run_to_run_bitwise" in lead:
            gate(lead["ranks_run_to_run_bitwise"], f"{name}: two runs differ")
        if "sp_on_off_bitwise" in lead:
            gate(lead["sp_off_loss_rel"] <= tol_loss and lead["sp_off_grad_norm_rel"] <= tol_gnorm
                 and lead["sp_off_param_max_rel"] <= tol_p,
                 f"{name}: the run without sequence parallelism is off the one-rank step")
            log(f"model mesh {name}: SP on and off bitwise: {lead['sp_on_off_bitwise']}")
    check(not failed, "model mesh: " + "; ".join(failed))
    return out


def _mesh_kernels(name: str) -> tuple:
    """The counters a run of the phase must move on every rank."""
    if name.startswith(("gin", "graphcast")):
        return ("segment_offsets", "segment_sum_edges", "segment_sum_gather_bwd")
    if name.startswith("detect"):
        return ("cms_update_keys",)
    if name.endswith("+grid"):
        return ("far_field", "near_field_rows", "segment_sum", "segment_offsets",
                "segment_sum_edges")
    if name.startswith("layout"):
        return ("repulsion_rows", "segment_offsets", "segment_sum_edges")
    return ()


# ------------------------------------------------------------- phase 17
# The serving mesh: LM decode on the sequence-sharded KV cache, prefill
# with sequence parallelism and SASRec's serve and retrieval on
# SERVE_RANKS ranks of one process each, sharing the card under gloo, each
# held against its one-rank step run first on the card in the parent
# (``serving_mesh_phase``). Serving weights are bfloat16 (``build_lm_step``'s
# rule), drawn at the true fan-in (``lm_params``, fault R6). A cache is
# seeded layer by layer from SEED (``_seeded_cache_layer``), so a rank
# makes its block of the same values without holding the whole cache.
SERVE_RANKS, SERVE_TIMEOUT = 2, 900
# 2 ranks against one, max abs of the bfloat16 logits and of the written
# K/V (unit-scale entries): split-K sums each softmax in another order,
# and from layer 1 on every input differs by that rounding. Sound readings
# (H100 80GB HBM3, 700.00 W, PERF.md §5): yi-6b decode logits 0.258, K/V
# 0.214; gemma3-4b 0.151, 0.113; the prefill 0.078, the same every run.
# A wrong split-K on the yi-6b decode (``tools/serving_mesh_phase.py
# --control``) read logits 3.79–4.28 and K/V 3.31 without the rescale,
# logits 6.08–6.09 and K/V 6.13 with the last rank's partial dropped.
SERVE_TOL = 0.3
# (run, arch, layers or None for the arch's, rows, S_max, each slot's
# length, active, steps). yi-6b ``decode_32k``: the rows cut from 128 to 8
# (the cache alone would be 275 GB at 128; 17.2 GB at 8, 8.6 GB a rank);
# lengths on both halves of the positions, the slot at 16,380 crossing the
# ranks' boundary at 16,384 on its fifth step, the last slot inactive.
# gemma3-4b ``long_500k``: 6 of 34 layers (cut from 12 to make room in the
# smoke's time limit: five local layers and the global layer 5; 12.9 GB of
# cache, 6.4 GB a rank), the one row near the end, so that rank 0's
# positions [0, 262,144) lie outside every local layer's 1,024-position
# window.
SERVE_DECODE_RUNS = (
    ("yi-6b-decode_32k", "yi-6b", None, 8, 32768,
     (96, 5000, 16380, 16384, 20000, 27000, 32000, 9000), (1, 1, 1, 1, 1, 1, 1, 0), 16),
    ("gemma3-4b-long_500k", "gemma3-4b", 6, 1, 524288, (523_990,), (1,), 4),
)
# yi-6b ``prefill_32k``: 1 row of 32,768 tokens (cut from 32 rows), 2 of 32
# layers (cut from 4 to make room in the smoke's time limit: at 4 layers
# each layer's gloo collectives took 1.8–2.3 s of the split run and 1.4–1.8
# s of the unsplit one, H100 80GB HBM3, 700.00 W); the sequence split over
# "model", then unsplit.
SERVE_PREFILL = ("yi-6b-prefill_32k", "yi-6b", 2, 1, 32768)
# SASRec uncut: (run, cell, mesh shape).
SERVE_SAS = (("sasrec-serve_p99-1x2", "serve_p99", (1, 2)),
             ("sasrec-serve_p99-2x1", "serve_p99", (2, 1)),
             ("sasrec-retrieval_cand-1x2", "retrieval_cand", (1, 2)))


def _serve_cfg(torch, arch_name: str, layers):
    """``(arch, cfg)``: the arch at full width, ``layers`` deep (None: all),
    its weights stored in the activation type (bfloat16)."""
    from repro_torch.configs import get_config

    arch = get_config(arch_name)
    cfg = dataclasses.replace(arch.model, n_layers=layers or arch.model.n_layers)
    cfg = dataclasses.replace(cfg, param_dtype=cfg.act_dtype)
    return dataclasses.replace(arch, model=cfg), cfg


def _seeded_cache_layer(torch, cfg, rows: int, s_max: int, layer: int, kv: int):
    """Layer ``layer``'s whole K (kv 0) or V (kv 1) cache, [rows, S_max,
    KV, hd] in the activation type, from a generator seeded by the layer:
    unit normals, the scale of K/V at the true fan-in."""
    gen = torch.Generator(device="cuda").manual_seed(SEED * 7919 + 2 * layer + kv)
    x = torch.randn((rows, s_max, cfg.n_kv_heads, cfg.head_dim), generator=gen, device="cuda")
    return x.to(cfg.act_dtype)


def _seed_cache(torch, cfg, rows: int, s_max: int, cache=None, block=None):
    """The seeded cache, or (``block``: the slices of a rank's block) that
    block written into ``cache`` in place."""
    if cache is None:
        n_rows = rows if block is None else len(range(rows)[block[1]])
        n_pos = s_max if block is None else len(range(s_max)[block[2]])
        shape = (cfg.n_layers, n_rows, n_pos, cfg.n_kv_heads, cfg.head_dim)
        cache = {k: torch.empty(shape, dtype=cfg.act_dtype, device="cuda") for k in "kv"}
    for i in range(cfg.n_layers):
        for j, k in enumerate("kv"):
            whole = _seeded_cache_layer(torch, cfg, rows, s_max, i, j)
            cache[k][i] = whole if block is None else whole[block[1], block[2]]
            del whole
    return cache


def _decode_tokens(np, cfg, rows: int, steps: int):
    rng = np.random.default_rng(SEED)
    return rng.integers(1, cfg.vocab, (steps, rows, 1)).astype(np.int64)


def _written_window(torch, cache, lengths, steps: int, p0: int = 0):
    """The cache at each slot's positions ``lengths[b] + t`` (t < steps),
    [L, B, steps, KV, hd] per K and V, and [B, steps] bool: the positions
    this block holds (positions start at ``p0``)."""
    n_pos = cache["k"].shape[2]
    pos = torch.as_tensor(lengths, device="cuda")[:, None] + torch.arange(steps, device="cuda")
    mine = (pos >= p0) & (pos < p0 + n_pos)
    idx = torch.where(mine, pos - p0, 0)
    rows = torch.arange(idx.shape[0], device="cuda")[:, None]
    return {k: v[:, rows, idx] for k, v in cache.items()}, mine


def _decode_one(torch, np, run, out_dir: str) -> dict:
    """A decode run of SERVE_DECODE_RUNS on one rank on the card: every
    step's logits and the written window, saved (host) for the ranks."""
    from repro_torch.models import transformer as tfm

    name, arch_name, layers, rows, s_max, lengths, active, steps = run
    _, cfg = _serve_cfg(torch, arch_name, layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cache = _seed_cache(torch, cfg, rows, s_max)
    step = tfm.make_decode_step(cfg)
    toks = _decode_tokens(np, cfg, rows, steps)
    cur = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    act = torch.as_tensor(active, dtype=torch.bool, device="cuda")
    logits, ms = [], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = step(params, cache, {"tokens": torch.as_tensor(toks[t], device="cuda"),
                                          "cur_len": cur, "active": act})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out.float().cpu())
        cur = cur + act.to(torch.int32)
    window, _ = _written_window(torch, cache, lengths, steps)
    res = {"logits": torch.stack(logits), "window": {k: v.cpu() for k, v in window.items()}}
    torch.save(res, os.path.join(out_dir, f"one-{name}.pt"))
    info = {"step_ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": sum(v.numel() * v.element_size() for v in cache.values())}
    del params, cache, out, window
    return info


def _decode_rank(torch, np, mesh, run, out_dir: str) -> dict:
    """A decode run on the rank's blocks (its positions of the cache), twice
    from the seeded cache: logits against the one-rank run's vocab block,
    the written window's owned entries (layer 0 bitwise, every layer within
    the tolerance), the rest of the block bitwise the seed, the two runs
    bitwise."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.params import local_block, shard_tree
    from repro_torch.sharding.rules import P

    name, arch_name, layers, rows, s_max, lengths, active, steps = run
    arch, cfg = _serve_cfg(torch, arch_name, layers)
    tol = SERVE_TOL
    built = build_step(arch, ShapeSpec("decode", "decode", seq_len=s_max, global_batch=rows), mesh)
    p_specs, c_specs, b_specs = built.in_specs
    whole = lm_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    params = shard_tree(whole, p_specs, mesh)
    del whole
    torch.cuda.empty_cache()
    shape = (cfg.n_layers, rows, s_max, cfg.n_kv_heads, cfg.head_dim)
    block = local_block(shape, c_specs["k"], mesh, mesh.coords)
    p0 = block[2].start or 0
    r0 = block[1].start or 0
    n_rows = len(range(rows)[block[1]])
    one = torch.load(os.path.join(out_dir, f"one-{name}.pt"))
    v_blk = local_block(one["logits"].shape[1:], built.out_specs[0], mesh, mesh.coords)
    want = one["logits"][(slice(None),) + v_blk]
    toks = _decode_tokens(np, cfg, rows, steps)
    rows_spec = P(b_specs["tokens"][0])
    lens = lengths[r0:r0 + n_rows]
    info = {"run": name, "rank": mesh.rank, "mesh": dict(mesh.shape), "layers": cfg.n_layers,
            "rows": rows, "s_max": s_max, "block": [p0, p0 + len(range(s_max)[block[2]])],
            "runs": []}
    outs = []
    cache = None
    for k in range(2):
        cache = _seed_cache(torch, cfg, rows, s_max, cache, block)
        cur = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
        act = torch.as_tensor(active, dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock = _CollectiveClock(dist)
        logits, ms = [], []
        try:
            for t in range(steps):
                batch = shard_tree({"tokens": torch.as_tensor(toks[t], device="cuda"),
                                    "cur_len": cur, "active": act},
                                   {"tokens": b_specs["tokens"], "cur_len": rows_spec,
                                    "active": rows_spec}, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, cache = built.fn(params, cache, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(out.float().cpu())
                cur = cur + act.to(torch.int32)
        finally:
            clock.remove()
        window, mine = _written_window(torch, cache, lens, steps, p0)
        outs.append((torch.stack(logits), {k: v.cpu() for k, v in window.items()}, mine.cpu()))
        info["runs"].append({"step_ms": ms, "collective_s": clock.seconds,
                             "collectives": clock.calls,
                             "peak_bytes": torch.cuda.max_memory_allocated()})
        if k == 0:  # every entry the steps did not write is the seed's
            written = torch.zeros(cache["k"].shape[1:3], dtype=torch.bool, device="cuda")
            pos = torch.as_tensor(lens, device="cuda")[:, None] + torch.arange(steps,
                                                                                device="cuda")
            a = torch.as_tensor(active[r0:r0 + n_rows], dtype=torch.bool, device="cuda")
            for b in range(n_rows):
                p = pos[b][(pos[b] >= p0) & (pos[b] < p0 + written.shape[1])] - p0
                if bool(a[b]):
                    written[b, p] = True
            same = True
            for i in range(cfg.n_layers):
                for j, key in enumerate("kv"):
                    seed = _seeded_cache_layer(torch, cfg, rows, s_max, i, j)[block[1], block[2]]
                    same &= bits_equal(torch, cache[key][i][~written], seed[~written])
                    del seed
            info["untouched_bitwise"] = bool(same)
    logits, window, mine = outs[0]
    info["max_abs_logits_vs_one"] = float((logits - want).abs().max())
    one_w = {k: v[:, r0:r0 + n_rows] for k, v in one["window"].items()}
    sel = mine[None, :, :, None, None].expand_as(window["k"])
    diffs = {k: (window[k].float() - one_w[k].float()).abs()[sel] for k in "kv"}
    info["window_max_abs_vs_one"] = max(float(d.max()) if d.numel() else 0.0
                                        for d in diffs.values())
    info["window_entries"] = int(sum(d.numel() for d in diffs.values()))
    info["window_not_bitwise"] = int(sum(int((d != 0).sum()) for d in diffs.values()))
    sel0 = mine[:, :, None, None].expand_as(window["k"][0])
    info["layer0_bitwise"] = all(bits_equal(torch, window[k][0][sel0], one_w[k][0][sel0])
                                 for k in "kv")
    info["run_to_run_bitwise"] = bits_equal(torch, outs[0][0], outs[1][0]) and all(
        bits_equal(torch, outs[0][1][k], outs[1][1][k]) for k in "kv")
    info["finite"] = bool(torch.isfinite(logits).all())
    info["tol"] = tol
    del params, cache, outs, one
    torch.cuda.empty_cache()
    dist.barrier()
    return info


def _prefill_one(torch, np, out_dir: str) -> dict:
    from repro_torch.models import transformer as tfm

    name, arch_name, layers, rows, seq = SERVE_PREFILL
    _, cfg = _serve_cfg(torch, arch_name, layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    toks = torch.as_tensor(_decode_tokens(np, cfg, rows, seq)[:, :, 0].T, device="cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = tfm.make_prefill(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    info = {"ms": (time.perf_counter() - t0) * 1e3, "peak_bytes": torch.cuda.max_memory_allocated()}
    torch.save(logits.cpu(), os.path.join(out_dir, f"one-{name}.pt"))
    del params, logits
    return info


def _prefill_rank(torch, np, mesh, out_dir: str) -> dict:
    """The prefill on the rank's blocks with the sequence split, then again
    unsplit (``seq_axis`` None: what sequence parallelism saves is the
    peak's difference); each logits block against the one-rank
    prefill's."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import build_step
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.params import local_block, shard_tree

    name, arch_name, layers, rows, seq = SERVE_PREFILL
    arch, cfg = _serve_cfg(torch, arch_name, layers)
    built = build_step(arch, ShapeSpec("prefill", "prefill", seq_len=seq, global_batch=rows), mesh)
    p_specs, b_specs = built.in_specs
    whole = lm_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    params = shard_tree(whole, p_specs, mesh)
    del whole
    toks = torch.as_tensor(_decode_tokens(np, cfg, rows, seq)[:, :, 0].T, device="cuda")
    batch = shard_tree({"tokens": toks}, b_specs, mesh)
    unsplit = tfm.make_prefill(cfg, dataclasses.replace(built.place, seq_axis=None))
    info = {"run": name, "rank": mesh.rank, "mesh": dict(mesh.shape), "layers": cfg.n_layers,
            "tokens": rows * seq, "sp": built.place.sp, "tol": SERVE_TOL}
    outs = []
    for key, fn in (("", built.fn), ("sp_off_", unsplit)):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        clock = _CollectiveClock(dist)
        try:
            t0 = time.perf_counter()
            with torch.no_grad():
                logits = fn(params, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            clock.remove()
        info.update({key + "ms": ms, key + "collective_s": clock.seconds,
                     key + "collectives": clock.calls,
                     key + "peak_bytes": torch.cuda.max_memory_allocated()})
        outs.append(logits.cpu())
        del logits
    one = torch.load(os.path.join(out_dir, f"one-{name}.pt"), mmap=True)
    want = one[local_block(one.shape, built.out_specs, mesh, mesh.coords)].to("cuda")
    for key, logits in zip(("", "sp_off_"), outs):
        logits = logits.to("cuda")
        info[key + "max_abs_logits_vs_one"] = float((logits.float() - want.float()).abs().max())
        info[key + "finite"] = bool(torch.isfinite(logits).all())
    info["bitwise_vs_one"] = bits_equal(torch, outs[0], want.cpu())
    info["sp_on_off_bitwise"] = bits_equal(torch, outs[0], outs[1])
    del params, outs, want, one, logits
    torch.cuda.empty_cache()
    dist.barrier()
    return info


def _sas_setup(torch, np, cell: str):
    """``(arch, shape, batch)`` of a SASRec serving cell, uncut, seeded."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SASRecStream

    arch = get_config("sasrec")
    cfg, shape = arch.model, arch.shapes[cell]
    seq = SASRecStream(cfg.n_items, shape.global_batch, cfg.seq_len, seed=SEED).batch_at(0)["seq"]
    batch = {"seq": torch.as_tensor(seq, device="cuda")}
    if shape.kind == "retrieval":
        rng = np.random.default_rng(SEED)
        batch["candidates"] = torch.as_tensor(
            rng.integers(1, cfg.n_items, shape.n_candidates).astype(np.int32), device="cuda")
    return arch, shape, batch


def _sas_one(torch, np, run, out_dir: str) -> dict:
    from repro_torch.models import sasrec as sas_lib

    _, cell, _ = run
    path = os.path.join(out_dir, f"one-{cell}.pt")
    if os.path.exists(path):  # another mesh's run of the same cell
        return {}
    arch, shape, batch = _sas_setup(torch, np, cell)
    params = sasrec_params(arch.model, torch.Generator(device="cuda").manual_seed(SEED))
    fn = (sas_lib.make_serve_step if shape.kind == "serve" else
          sas_lib.make_retrieval_step)(arch.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(params, batch)
    torch.cuda.synchronize()
    info = {"ms": (time.perf_counter() - t0) * 1e3}
    torch.save(out.cpu(), path)
    return info


def _sas_rank(torch, np, mesh, run, out_dir: str) -> dict:
    """A SASRec serving cell on the rank's blocks, twice: its scores block
    against the one-rank step's, and the two runs bitwise."""
    import torch.distributed as dist

    from repro_torch.launch.steps import build_step
    from repro_torch.sharding.params import local_block, shard_tree

    name, cell, _ = run
    arch, shape, batch = _sas_setup(torch, np, cell)
    built = build_step(arch, shape, mesh)
    p_specs, b_specs = built.in_specs
    params = shard_tree(sasrec_params(arch.model, torch.Generator(device="cuda").manual_seed(SEED)),
                        p_specs, mesh)
    local = shard_tree(batch, b_specs, mesh)
    outs, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = _CollectiveClock(dist)
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(built.fn(params, local))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        clock.remove()
    peak = torch.cuda.max_memory_allocated()
    one = torch.load(os.path.join(out_dir, f"one-{cell}.pt"), mmap=True)
    want = one[local_block(one.shape, built.out_specs, mesh, mesh.coords)].to("cuda")
    info = {"run": name, "rank": mesh.rank, "mesh": dict(mesh.shape), "ms": ms,
            "collective_s": clock.seconds, "collectives": clock.calls, "peak_bytes": peak,
            "max_abs_vs_one": float((outs[0] - want).abs().max()),
            "run_to_run_bitwise": bits_equal(torch, outs[0], outs[1]),
            "tol": TF_TOL["float32"]}
    del params, outs, want, one
    torch.cuda.empty_cache()
    dist.barrier()
    return info


def serve_mesh_rank(_stream_mesh, out_dir: str) -> None:
    """One rank of the serving mesh phase (spawned by
    ``serving_mesh_phase``): SERVE_DECODE_RUNS and SERVE_PREFILL on (1, 2),
    SERVE_SAS on their meshes; writes ``out_dir/rank{r}.json``."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_model_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_model_mesh(shape, ("data", "model"), backend="gloo")
        return meshes[shape]

    out = [_decode_rank(torch, np, mesh_of((1, 2)), run, out_dir) for run in SERVE_DECODE_RUNS]
    out.append(_prefill_rank(torch, np, mesh_of((1, 2)), out_dir))
    out += [_sas_rank(torch, np, mesh_of(run[2]), run, out_dir) for run in SERVE_SAS]
    with open(os.path.join(out_dir, f"rank{_stream_mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def serving_mesh_phase(torch, np, smi: str) -> dict:
    """LM serving and SASRec on SERVE_RANKS ranks sharing the card under
    gloo (``serve_mesh_rank``), each run's one-rank counterpart first, on
    the card in this process (its outputs saved on the host, its memory
    freed):

    * yi-6b ``decode_32k`` (full width and depth, 8 rows × 32,768
      positions, 16 steps) and gemma3-4b ``long_500k`` (6 layers, 1 row ×
      524,288 positions, 4 steps) on (1, 2), the cache split by position;
    * yi-6b ``prefill_32k`` (2 layers, 32,768 tokens) on (1, 2), the
      sequence split;
    * SASRec ``serve_p99`` on (1, 2) and (2, 1), ``retrieval_cand`` on (1, 2).
    Gates: decode logits within SERVE_TOL of the one-rank decode, the
    cache entries the steps did not write bitwise the seed, layer 0's
    written entries bitwise the one-rank cache's and every written entry
    within SERVE_TOL (split-K rounds the later layers' inputs otherwise),
    two runs bitwise; the prefill's logits within SERVE_TOL, with the
    sequence split and unsplit (whether the two were bitwise is logged);
    SASRec within TF_TOL["float32"], two runs bitwise. Prints each rank's
    step ms, collective seconds and calls, and peak bytes beside the
    one-rank step's (the prefill's with and without sequence
    parallelism)."""
    from repro_torch.launch.mesh import spawn_local

    out = {"card": smi, "one": {}, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for run in SERVE_DECODE_RUNS:
            out["one"][run[0]] = _decode_one(torch, np, run, tmp)
            gc.collect()
            torch.cuda.empty_cache()
        out["one"][SERVE_PREFILL[0]] = _prefill_one(torch, np, tmp)
        for run in SERVE_SAS:
            out["one"][run[0]] = _sas_one(torch, np, run, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["one_rank_s"] = time.perf_counter() - t0
        log("serving mesh one-rank " + json.dumps(out["one"]))
        t0 = time.perf_counter()
        spawn_local(serve_mesh_rank, SERVE_RANKS, backend="gloo",
                    init_file=str(Path(tmp) / "store"), args=(tmp,), timeout=SERVE_TIMEOUT)
        out["ranks_s"] = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(SERVE_RANKS)]
    failed = []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    for infos in zip(*ranks):
        name = infos[0]["run"]
        out["runs"][name] = list(infos)
        log(f"serving mesh {name} " + json.dumps(list(infos)))
        for r in infos:
            who = f"{name} rank {r['rank']}"
            if "max_abs_vs_one" in r:  # SASRec
                gate(r["max_abs_vs_one"] <= r["tol"] and r["run_to_run_bitwise"],
                     f"{who}: scores {r['max_abs_vs_one']} off the one-rank step, or two "
                     "runs differ")
                continue
            gate(r["finite"] and r["max_abs_logits_vs_one"] <= r["tol"],
                 f"{who}: logits {r['max_abs_logits_vs_one']} off the one-rank step")
            if "window_max_abs_vs_one" in r:  # decode
                gate(r["untouched_bitwise"] and r["layer0_bitwise"],
                     f"{who}: the cache changed where no step wrote, or layer 0's new K/V "
                     "differ from the one-rank cache's")
                gate(r["window_max_abs_vs_one"] <= r["tol"],
                     f"{who}: written K/V {r['window_max_abs_vs_one']} off the one-rank cache")
                gate(r["run_to_run_bitwise"], f"{who}: two runs differ")
            else:
                gate(r["sp"], f"{who}: the sequence was not split")
                gate(r["sp_off_finite"] and r["sp_off_max_abs_logits_vs_one"] <= r["tol"],
                     f"{who}: unsplit logits {r['sp_off_max_abs_logits_vs_one']} off the "
                     "one-rank step")
    check(not failed, "serving mesh: " + "; ".join(failed))
    log(f"serving mesh: {out['one_rank_s']:.3f} s one-rank, {out['ranks_s']:.3f} s for the "
        f"spawned ranks ({smi})")
    return out


def run() -> int:
    t_start = time.perf_counter()
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
        main_launches, main_wall, main_result, main_cfg = main_path(
            torch, np, cap, edges, delta)
    with phase("full path"):
        full_launches = full_path(torch, np, cap, edges, delta, main_wall)
    with phase("bfloat16"):
        half = half_layout_phase(torch, np, cap, edges, main_result, main_cfg)
    with phase("serve"):
        serve_phase(torch, np, cap, edges, main_result, main_cfg)
    with phase("launchers"):
        launcher_phase(np)
    with phase("multi-device"):
        multi_launches, half["launches"]["multi_bf16"] = multi_device_phase(
            torch, np, edges, main_result, main_cfg, smi, half["positions"])
    with phase("timing"):
        rows = time_kernels(torch, np, cap, main_launches, full_launches, multi_launches,
                            half["launches"])
    timed = sorted(k for k, v in KERNELS.items() if v[3] not in ("train", "step"))
    check(sorted(r["name"] for r in rows) == timed,
          f"kernel rows {sorted(r['name'] for r in rows)}, expected {timed}")
    full_nodes = cap.calls["count_disks@full"][1]
    cap.calls.clear()
    torch.cuda.empty_cache()
    with phase("consistency"):
        full_node_consistency(torch, np, full_nodes)
        consistency(torch, np)
    with phase("resilience"):
        resilience_phase(torch, np, cap, edges, main_result, main_cfg, main_wall, smi)
    del main_result
    torch.cuda.empty_cache()
    with phase("dry-run cells"):
        rows += dry_run_phase(torch, np, cap, edges)
    del edges
    torch.cuda.empty_cache()
    with phase("models"):
        models_phase(torch, np, cap, smi)
    with phase("training"):
        rows += training_phase(torch, np, cap, smi)
    with phase("dry run"):
        dry_run_smoke_phase(torch, np, smi)
    with phase("model mesh"):
        model_mesh_phase(torch, np, smi)
    with phase("serving mesh"):
        serving_mesh_phase(torch, np, smi)
    check(sorted(r["name"] for r in rows) == sorted(KERNELS),
          f"kernel rows {sorted(r['name'] for r in rows)}, expected {sorted(KERNELS)}")
    log(json.dumps({"kernels": rows}))
    log(f"chip_smoke seconds {time.perf_counter() - t_start:.3f}")
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
