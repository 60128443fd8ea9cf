#!/usr/bin/env python3
"""Time an older tree's kernels against this tree's, on one GPU, on the
inputs the main and full paths give them: K1 (merge placement), K3 (the
edge chunks' raw scatter, and the small-disk node pass), K4 (disk_accum),
K6 (near_field), K7 (segment_sum) and K8 (the CMS update).

    git archive <commit> | tar -x -C build/parent    # build/ is ignored by git
    python3 tools/kernel_compare.py build/parent

It runs ``biggraphvis`` + ``render`` as ``chip_smoke.py`` does (685,230
nodes, 100 iterations), recording K1's first and last merge, K3's largest
edge chunk and node pass, K4's node pass and the CMS update, then
``full_layout_colored`` (grid 64, window 32, 500 iterations), recording
K6's and K7's inputs from one more iteration at the final layout
(``chip_smoke.record_grid_inputs``) and K3's from one node pass and one
edge chunk of its render (``chip_smoke.record_render_inputs``). Each older
``src/repro_torch/csrc/<name>.cu`` is compiled with this tree's ``nvcc``
flags. Where the C interface is kept (K3's raw entry, K6, K7), the older
library sits behind this tree's wrapper. Elsewhere the older tree's own
modules are loaded from its directory and call the older library:

- K1 kernel: the older generic atomic kernel alone on the concatenated
  runs, its outputs filled outside the timed span, against this tree's
  ``merge_place``; K1 placement: the older ``scatter_combine`` as a whole
  (four ``torch.cat``, three fills, the atomic kernel) against
  ``merge_place``;
- K3 node pass: the older renderer's ``_small_disk_splat`` (the torch
  materialisation of every disk's box and the older raw K3) against this
  tree's ``count_disks_into``, on each path's small disks;
- K4: a fresh ``disk_accum`` (this tree's includes the zero fill);
- K8 kernel: the older ``kernels.cms.ops.update_hashed`` against this
  tree's, on hashed buckets; K8 end to end: the older
  ``core.cms.update`` against this tree's, on the keys.

Every version is held bitwise against the plain version, then timed by
``chip_smoke.cuda_ms`` over ``chip_smoke.REPS`` launches queued behind a
device sleep, in the order older, this, this, older, ``ROUNDS`` times.
Prints one JSON line and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

KERNELS = ("merge_scatter", "count_scatter", "disk_accum", "near_field", "segment_sum",
           "cms_update")
ROUNDS = 2


def compile_older(tree: Path, name: str) -> ctypes.CDLL:
    out = build.BUILD_DIR.parent / "kernel_compare" / f"{name}-older.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = tree / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def older_module(tree: Path, rel: str, name: str):
    """A wrapper module of the older tree, loaded from its file; its imports
    of ``repro_torch`` resolve to this tree (``build``, the plain versions)."""
    spec = importlib.util.spec_from_file_location(name, tree / "src" / "repro_torch" / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def merge_calls(store: dict):
    """Record the first and the last call of ``merge_place`` (cloned)."""
    from repro_torch.kernels.merge import ops as merge_ops

    real = merge_ops.merge_place

    def rec(*args):
        cl = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args)
        store.setdefault("first", cl)
        store["last"] = cl
        return real(*args)

    merge_ops.merge_place = rec
    try:
        yield
    finally:
        merge_ops.merge_place = real


def main_inputs(edges, delta):
    """K1's first and last merge, and the ``chip_smoke.Capture`` of one run
    of the main path."""
    import repro_torch

    n = smoke.NODES
    cfg = repro_torch.default_config(n, len(edges), delta, iterations=smoke.ITERATIONS)
    scfg = repro_torch.StreamConfig(chunk_size=1 << 16)
    cap = smoke.Capture(torch)
    merges = {}
    with tempfile.TemporaryDirectory() as tmp, cap.recording(), merge_calls(merges):
        repro_torch.biggraphvis(edges, n, cfg, scfg, device="cuda").render(
            str(Path(tmp) / "main.png"))
    torch.cuda.synchronize()
    return merges, cap


def run(older: Path) -> dict:
    import numpy as np

    import repro_torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.grid.ref import near_field_ref
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.core import cms as cms_lib
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.cms.ref import cms_update_ref
    from repro_torch.kernels.merge.ref import merge_place_ref
    from repro_torch.kernels.raster import ops as raster_ops
    from repro_torch.kernels.raster.ref import (
        count_disks_into_ref,
        count_scatter_into_ref,
        disk_accum_ref,
    )
    from repro_torch.kernels.segment.ref import segment_sum_ref

    resolve_device("cuda")
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        futs = {k: ex.submit(compile_older, older, k) for k in KERNELS}
        build.build(KERNELS)
        libs = {"older": {k: f.result() for k, f in futs.items()},
                "this": {k: build.library(k) for k in KERNELS}}
    old_merge = older_module(older, "kernels/merge/ops.py", "older_merge_ops")
    old_raster = older_module(older, "kernels/raster/ops.py", "older_raster_ops")
    old_render = older_module(older, "render/raster.py", "older_render_raster")
    old_cms_ops = older_module(older, "kernels/cms/ops.py", "older_cms_ops")
    old_cms = older_module(older, "core/cms.py", "older_core_cms")

    edges, delta = smoke.make_graph()
    merges, main_cap = main_inputs(edges, delta)
    acc_meta, cx, cy, r, g, ng = main_cap.calls["disk_accum"][1]
    cap = smoke.Capture(torch)
    n = smoke.NODES
    cfg = repro_torch.default_config(n, len(edges), delta, grid_size=smoke.GRID,
                                     grid_window=smoke.WINDOW, grid_rebuild=1)
    pos, groups = repro_torch.full_layout_colored(edges, n, cfg,
                                                  iterations=smoke.FULL_ITERATIONS,
                                                  device="cuda")
    smoke.record_grid_inputs(torch, cap, edges, pos)
    smoke.record_render_inputs(cap, edges, pos, groups)
    _, (pos_s, mass_s, cell_s, kr, w), _ = cap.calls["near_field"]
    _, (data, seg, n_seg), kw = cap.calls["segment_sum"]
    k6, k7 = cap.fn("near_field"), cap.fn("segment_sum")
    _, h, wd = acc_meta.shape

    # (name, {version: call, and optionally version_check: the call to
    # check, where the timed one reuses its outputs}, plain result)
    cases = [
        ("near_field", dict.fromkeys(("older", "this"), lambda: k6(pos_s, mass_s, cell_s, kr, w)),
         near_field_ref(pos_s, mass_s, cell_s, kr, w)),
        ("segment_sum", dict.fromkeys(("older", "this"), lambda: k7(data, seg, n_seg, **kw)),
         segment_sum_ref(data.cpu(), seg.cpu(), n_seg)),
        ("disk_accum", {"older": lambda: old_raster.disk_accum(cx, cy, r, g, ng, h, wd),
                        "this": lambda: raster_ops.disk_accum(cx, cy, r, g, ng, h, wd)},
         disk_accum_ref(cx, cy, r, g, ng, h, wd)),
    ]
    inputs = {"near_field": {"n": int(pos_s.shape[0]), "window": w},
              "segment_sum": {"segments": n_seg, "largest_segment": int(torch.bincount(
                  seg[(seg >= 0) & (seg < n_seg)].long()).max())},
              "disk_accum": {"disks": int(cx.numel()), "out": [ng, h, wd]}}
    def in_place(older_fn, this_fn, fresh):
        """Versions of an in-place call: the timed ones add into one
        accumulator each, the checked ones into a fresh one."""
        acc = {"older": fresh(), "this": fresh()}
        return {"older": lambda: older_fn(acc["older"]), "this": lambda: this_fn(acc["this"]),
                "older_check": lambda: older_fn(fresh()), "this_check": lambda: this_fn(fresh())}

    for path, tag_cap, tag in (("main", main_cap, ""), ("full", cap, "@full")):
        # K3's raw entry on the recorded edge chunk: this tree's wrapper on
        # the older library or this one.
        _, (acc0, pos3, inc3), _ = tag_cap.calls["count_scatter" + tag]

        def raw(acc, p=pos3, i=inc3):
            return raster_ops.count_scatter_into(acc, p, i)

        cases.append((f"count_scatter_{path}", in_place(raw, raw, acc0.clone),
                      count_scatter_into_ref(acc0.clone(), pos3, inc3)))
        size = acc0.numel()
        inputs[f"count_scatter_{path}"] = {
            "rows": int(pos3.numel()), "kept": int(((pos3 >= 0) & (pos3 < size)).sum()),
            "inc": inc3 is not None}
        # K3's node pass: the older torch materialisation + the older raw
        # K3, against the disk entry.
        meta, px, py, rr, gg, ngg = tag_cap.calls["count_disks" + tag][1]
        shape = tuple(meta.shape)

        def zeros(shape=shape):
            return torch.zeros(shape, dtype=torch.int32, device="cuda")

        def older_disks(acc, px=px, py=py, rr=rr, gg=gg, ngg=ngg):
            old_render._small_disk_splat(px, py, rr, gg, ngg, acc.shape[1], acc.shape[2],
                                         acc.view(-1))
            return acc

        def this_disks(acc, px=px, py=py, rr=rr, gg=gg, ngg=ngg):
            return raster_ops.count_disks_into(acc, px, py, rr, gg, ngg)

        cases.append((f"node_pass_{path}", in_place(older_disks, this_disks, zeros),
                      count_disks_into_ref(zeros(), px, py, rr, gg, ngg).cpu()))
        inputs[f"node_pass_{path}"] = {"disks": int(px.numel()), "out": list(shape)}
    # K8 on the main path's CMS input: the hashed kernel, then the
    # pipeline's core.cms.update end to end (the older one hashes in torch
    # and adds by index_put_; this one launches the keys-in kernel).
    _, (sketch, keys, weights, ccfg), _ = main_cap.calls["cms_update"]
    h8 = cms_ops.hashed_buckets(keys, ccfg)
    wv = weights.to(torch.float32).contiguous()
    want8 = cms_update_ref(sketch, h8, wv)
    cases.append(("cms_update_hashed", {
        "older": lambda: old_cms_ops.update_hashed(sketch, h8, wv),
        "this": lambda: cms_ops.update_hashed(sketch, h8, wv)}, want8))
    cases.append(("cms_update_end_to_end", {
        "older": lambda: old_cms.update(sketch, keys, weights, ccfg),
        "this": lambda: cms_lib.update(sketch, keys, weights, ccfg)}, want8))
    inputs["cms_update"] = {"rows": int(h8.shape[0]), "cols": int(sketch.shape[1]),
                            "n": int(h8.shape[1])}
    for which in ("first", "last"):
        runs = merges[which]
        ps, sa, sb, sw, pc, ca, cb, cw, capn = runs
        cat = [torch.cat([x, y]) for x, y in zip((ps, sa, sb, sw), (pc, ca, cb, cw))]
        outs = [torch.empty(capn, dtype=torch.int32, device="cuda"),
                torch.empty(capn, dtype=torch.int32, device="cuda"),
                torch.empty(capn, device="cuda")]

        def fill(outs=outs):
            outs[0].fill_(-1)
            outs[1].fill_(-1)
            outs[2].zero_()

        def old_kernel(cat=cat, outs=outs, capn=capn):
            fn = build.entry("merge_scatter", old_merge._ARGTYPES)
            code = fn(*(build.ptr(t) for t in cat), cat[0].numel(), capn,
                      *(build.ptr(t) for t in outs), build.stream(cat[0].device))
            build.check("merge_scatter", code)
            return outs

        def old_kernel_checked(old_kernel=old_kernel, fill=fill):
            fill()
            return old_kernel()

        def old_placement(runs=runs):
            ps, sa, sb, sw, pc, ca, cb, cw, capn = runs
            return old_merge.scatter_combine(torch.cat([ps, pc]), torch.cat([sa, ca]),
                                             torch.cat([sb, cb]), torch.cat([sw, cw]), capn)

        def this(runs=runs):
            return merge_ops.merge_place(*runs)

        want = merge_place_ref(*runs)
        cases.append((f"merge_kernel_{which}", {"older": old_kernel, "this": this,
                                                 "older_check": old_kernel_checked},
                      want))
        cases.append((f"merge_placement_{which}", {"older": old_placement, "this": this},
                      want))
        kept = int(((cat[0] >= 0) & (cat[0] < capn)).sum())
        inputs[f"merge_{which}"] = {"rows": int(cat[0].numel()), "kept": kept, "cap": capn}

    def bitwise(got, want):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(smoke.bits_equal(torch, a.cpu(), b.cpu()) for a, b in zip(got, want))

    ms = {name: {"older": [], "this": []} for name, *_ in cases}
    this_library = build.library
    try:
        for _ in range(ROUNDS):
            for name, calls, want in cases:
                for version in ("older", "this", "this", "older"):
                    build.library = libs[version].__getitem__
                    check = calls.get(f"{version}_check", calls[version])
                    smoke.check(bitwise(check(), want),
                                f"{version} {name} differs from its plain version")
                    ms[name][version].append(smoke.cuda_ms(torch, calls[version], smoke.REPS))
    finally:
        build.library = this_library
    means = {name: {v: float(np.mean(t)) for v, t in d.items()} for name, d in ms.items()}
    return {"input": inputs, "reps": smoke.REPS, "bitwise": True, "ms": ms,
            "mean_ms": means}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 2
    print(json.dumps(run(Path(sys.argv[1]).resolve())), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
