"""The dry run on the production meshes (``repro_torch.launch.dryrun``,
``launch/op_analysis.py``) and the kernel entries' abstract rules, on the
CPU.

* The op counter against the reference's ``analyze_hlo``: a chain of two
  products with an all-reduce and an all-gather over four ranks (the port
  as rank 0 of a fake world of four, the reference lowered on four host
  devices, ``tests/torch_dryrun_ref.py``) — dot FLOPs, dot traffic and
  every kind's payload equal; a dense LM's train step and prefill at 2
  layers on (2, 2) — per-device dot FLOPs within the K/V projections'
  share (below); gin-tu's and graphcast's ``full_graph_sm`` train steps on
  one rank and on (2, 2) — per-device dot FLOPs within 0.5 % (the node
  state split over every axis, as the reference's).
* A 2-rank step's counted collectives (calls and payload bytes, as rank 0
  of a fake world) equal to those the same step issues on a real 2-rank
  gloo group (``tests/torch_dryrun_worker.py``).
* Every abstract rule: its output's shape, dtype and strides those of the
  plain version on real CPU tensors; no plain version traced under the
  fake mode (the wrappers and their callers, ``fa2._attraction`` and
  ``core.cms.update``); no launch counted; its operations and bytes giving
  PERF.md §6's bound, to its printed digits, at that table's inputs.
* K5's and K6's costs: the printed bounds at the rows' same-cell pairs;
  a grid-form ``layout_berkstan`` step traced on fake tensors on one rank
  and on (2, 2), with K5's and K6's rules and no plain version.
* gin-tu ``ogb_products`` on a mesh of one: a step's 20 K7 sums, 10 gather
  backwards and 2 layout builds.
* The CLI in subprocesses: two cells and every skipped cell, with the keys
  and values ``tests/test_dryrun_evidence.py`` demands of the reference's
  records.

Why the LM's FLOPs are not equal: the port computes the K/V projections
whole on every rank (no sharding profile maps "kv_heads",
``models/transformer.py``), where the reference's partitioner splits some
of those products over "model" (each split one does 1/M of the work). So
the port counts more, by at most (1 − 1/M) of its K/V projections' FLOPs:
measured, the whole gap of the prefill is one of the two projections split
in each layer (131,072 FLOPs), the train step's 786,432 of the bound's
1,048,576.
"""
import json
import os
from dataclasses import replace
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_dryrun_worker as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.lm_archs import smoke_lm  # noqa: E402
from repro_torch.core import cms as cms_lib  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.cms import ops as cms_ops  # noqa: E402
from repro_torch.kernels.grid import ops as grid_ops  # noqa: E402
from repro_torch.kernels.repulsion import ops as rep_ops  # noqa: E402
from repro_torch.kernels.segment import ops as seg_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, spawn_local  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
FakeTensorMode = torch._subclasses.fake_tensor.FakeTensorMode
# H100 SXM: HBM bytes/s and float32 operations/s (chip_smoke.py's bound).
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", **extra)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The reference's analyses, the port's traces and the 2-rank gloo run,
    at once."""
    d = tmp_path_factory.mktemp("dryrun")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dryrun_ref.py"),
                            str(d / "ref.json")],
                           env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dryrun_worker.py"),
                             str(d / "port.json")], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    spawn_local(W.gloo_rank, 2, device="cpu", init_file=str(d / "store"),
                args=(str(d / "gloo.json"),), timeout=TIMEOUT)
    out = {}
    for name, proc in (("ref", ref), ("port", port)):
        log, _ = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, log[-4000:]
        out[name] = json.loads((d / f"{name}.json").read_text())
    out["gloo"] = json.loads((d / "gloo.json").read_text())
    return out


def test_chain_counts_match_the_reference_hlo_analysis(sides):
    ref, port = sides["ref"]["chain"], sides["port"]["chain"]
    assert port["dot_flops"] == ref["dot_flops"]
    assert port["dot_traffic_bytes"] == ref["dot_traffic_bytes"]
    assert port["collective_counts"] == ref["collective_counts"]
    assert port["n_dots"] == ref["n_dots"]


def _kv_projection_flops(kind: str) -> float:
    """The port's K/V projection FLOPs on one rank of W.LM_MESH: per layer
    two [T, d] × [d, KV·hd] products on the rank's rows of the whole
    sequence; a train step runs each in the forward, the remat recompute
    and twice in the backward (the input's and the weight's gradients)."""
    cfg = smoke_lm()
    rows, seq = W.LM_SHAPE
    t = rows // W.LM_MESH[0] * seq
    passes = 4 if kind == "train" else 1
    return passes * cfg.n_layers * 2 * (2.0 * t * cfg.d_model * cfg.n_kv_heads * cfg.head_dim)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_lm_dot_flops_match_the_reference_within_the_kv_share(sides, kind):
    """0 ≤ port − reference ≤ (1 − 1/M) of the port's K/V projections'
    FLOPs (the module docstring)."""
    ref, port = sides["ref"][kind]["dot_flops"], sides["port"][kind]["dot_flops"]
    m = W.LM_MESH[1]
    assert 0 <= port - ref <= (1 - 1 / m) * _kv_projection_flops(kind), (port, ref)


GNN_DOT_RTOL = 0.005


@pytest.mark.parametrize("cell", [f"{a} {c}" for a, c in W.GNN_CELLS])
def test_gnn_dot_flops_match_the_reference_per_device(sides, cell):
    """The GNN mesh form splits the node rows over every axis as the
    reference's constraint does, so each device's products are a quarter
    of one device's on (2, 2), the reference's number within GNN_DOT_RTOL
    on one device and on the mesh. The reference's ``n_dots`` counts the
    dot instructions of its HLO, a scan's body once; the port counts every
    product it runs, so its count is held against its own one-rank step:
    the split runs every product, on fewer rows."""
    one, split = f"{cell} (1, 1)", f"{cell} {W.GNN_MESH}"
    ref, port = sides["ref"]["gnn"], sides["port"]["gnn"]
    for key in (one, split):
        assert abs(port[key]["dot_flops"] / ref[key]["dot_flops"] - 1) <= GNN_DOT_RTOL, \
            (key, port[key]["dot_flops"], ref[key]["dot_flops"])
    assert abs(port[split]["dot_flops"] * 4 / port[one]["dot_flops"] - 1) <= GNN_DOT_RTOL
    assert port[split]["n_dots"] == port[one]["n_dots"]
    assert ref[split]["n_dots"] == ref[one]["n_dots"]


def test_fake_collectives_are_those_a_gloo_run_issues(sides):
    fake, real = sides["port"]["gloo_cell"], sides["gloo"]
    assert fake["collective_calls"] == real["collective_calls"]
    assert fake["collective_counts"] == pytest.approx(real["collective_counts"], rel=1e-12)


# ------------------------------------------------------------------- rules
def _rng_inputs():
    g = torch.Generator().manual_seed(0)
    n, e = 300, 2000
    pos = torch.randn((n, 2), generator=g) * 10
    mass = torch.rand(n, generator=g) + 1
    radii = torch.rand(n, generator=g)
    src = torch.sort(torch.randint(0, n + 1, (e,), generator=g, dtype=torch.int32)).values
    dst = torch.randint(0, n + 1, (e,), generator=g, dtype=torch.int32)
    w = torch.rand(e, generator=g)
    data = torch.randn((e, 5), generator=g)
    keys = torch.randint(-1, 50, (e,), generator=g, dtype=torch.int32)
    cell, order = grid_ops.bin_and_sort(pos, 8)
    idx = order.long()
    pos_s, mass_s, cell_s = pos[idx], mass[idx], cell[idx]
    # The cell statistics by index_add_ (the tests refuse K7's plain version).
    sums = torch.zeros(64, 3).index_add_(
        0, cell_s.long(), torch.cat([pos_s * mass_s[:, None], mass_s[:, None]], 1))
    cmass = sums[:, 2].contiguous()
    ccent = sums[:, :2] / torch.clamp(cmass, min=1e-9)[:, None]
    return dict(n=n, e=e, pos=pos, mass=mass, radii=radii, src=src, dst=dst, w=w, data=data,
                keys=keys, pos_s=pos_s, mass_s=mass_s, cell_s=cell_s, ccent=ccent, cmass=cmass)


def _gather_bwd(x, idx):
    x = x.detach().requires_grad_(True)
    seg_ops.gather_rows(x, idx).sum().backward()
    return x.grad


CMS = cms_lib.CMSConfig(rows=4, cols=37)
# entry → its call on a dict of inputs (``_rng_inputs``)
ENTRIES = {
    "repulsion_nbody": lambda t: rep_ops.repulsion(t["pos"], t["mass"], 1.5, radii=t["radii"]),
    "repulsion_rows": lambda t: rep_ops.repulsion_rows(t["pos"], t["mass"], 100, 150, 1.5,
                                                       radii=t["radii"]),
    "segment_offsets": lambda t: seg_ops.segment_offsets(t["src"], t["n"]),
    "segment_sum": lambda t: seg_ops.segment_sum(t["data"], t["dst"], t["n"]),
    "attraction_sum": lambda t: seg_ops.attraction_sum(
        t["pos"], t["dst"], t["w"], seg_ops.segment_layout(t["src"], t["n"], sorted=True)),
    "segment_sum_edges": lambda t: seg_ops.segment_sum_edges(t["data"], t["dst"], t["n"]),
    "segment_sum_gather_bwd": lambda t: _gather_bwd(t["pos"], t["dst"]),
    "cms_update_keys": lambda t: cms_ops.update(torch.zeros(4, 37), t["keys"], t["w"], CMS),
    "cms_update": lambda t: cms_ops.update_hashed(
        torch.zeros(4, 37), cms_ops.hashed_buckets(t["keys"], CMS), t["w"]),
    "far_field": lambda t: grid_ops.far_field(t["pos_s"], t["mass_s"], t["cell_s"], t["ccent"],
                                              t["cmass"], 2.0),
    "near_field": lambda t: grid_ops.near_field_sorted(t["pos_s"], t["mass_s"], t["cell_s"],
                                                       2.0, 8),
    "near_field_rows": lambda t: grid_ops.near_field_rows(t["pos_s"], t["mass_s"], t["cell_s"],
                                                          2.0, 8, 100, 150),
}
_PLAIN = {rep_ops: ("repulsion_ref", "repulsion_chunked", "repulsion_chunked_rows"),
          grid_ops: ("far_field_ref", "near_field_ref", "near_field_rows_ref"),
          seg_ops: ("segment_offsets_ref", "segment_sum_ref", "segment_sum_layout_ref",
                    "attraction_sum_ref"),
          cms_ops: ("cms_update_ref",)}


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain kernel version raises while the test runs."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} traced in place of a kernel")
        return f

    for mod, names in _PLAIN.items():
        for name in names:
            monkeypatch.setattr(mod, name, refuse(name))


def _fake_tree(mode, t):
    return {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v for k, v in t.items()}


def _meta(x):
    return tuple(x.shape), x.dtype, x.stride()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_rule_metadata_equals_the_plain_version(entry, monkeypatch):
    real = _rng_inputs()
    want = _meta(ENTRIES[entry](real))
    seen = []
    monkeypatch.setattr(build, "RULE_OBSERVERS", [lambda *a: seen.append(a)])
    launches = dict(build.LAUNCHES)
    mode = FakeTensorMode()
    with mode:
        got = ENTRIES[entry](_fake_tree(mode, real))
    assert build.is_fake(got) and _meta(got) == want
    names = [s[0] for s in seen]  # a layout built on the way counts its offsets first
    assert names[-1] == entry and set(names[:-1]) <= {"segment_offsets"}, names
    assert build.LAUNCHES == launches


def test_fake_tensors_never_take_a_plain_version(no_plain, monkeypatch):
    """Both devices' fake tensors (CPU here) take the rules, through the
    wrappers and their callers: FA2's two-scatter attraction and the CMS
    update."""
    real = _rng_inputs()
    seen = []
    monkeypatch.setattr(build, "RULE_OBSERVERS", [lambda *a: seen.append(a[0])])
    mode = FakeTensorMode()
    with mode:
        t = _fake_tree(mode, real)
        for fn in ENTRIES.values():
            fn(t)
        edges = torch.stack([t["dst"], t["dst"].flip(0)], 1).clamp(max=t["n"] - 1)
        fa2._attraction(t["pos"], edges, t["w"], t["n"])
        cms_lib.update(torch.zeros(4, 37), t["keys"], t["w"], CMS)
    assert set(ENTRIES) <= set(seen)
    assert seen[-2:] == ["segment_sum_edges", "cms_update_keys"]


def _fake(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def _sorted_ids(e):
    """E ascending ids: the rule reads only their shape."""
    return _fake((e,), torch.int32)


# PERF.md §6's rows: (entry, the call at the row's inputs, its bound ms as printed).
BOUND_ROWS = [
    ("repulsion_nbody", lambda: rep_ops.repulsion(_fake((16384, 2)), _fake(16384), 1.0,
                                                  radii=_fake(16384)), "0.0681"),
    ("repulsion_rows", lambda: rep_ops.repulsion_rows(_fake((16384, 2)), _fake(16384), 8192,
                                                      8192, 1.0, radii=_fake(16384)), "0.0341"),
    ("segment_sum", lambda: seg_ops.segment_sum(_fake((685230, 3)), _fake(685230, torch.int32),
                                                4096, indices_are_sorted=True), "0.00329"),
    ("segment_offsets", lambda: seg_ops.segment_offsets(_sorted_ids(524288), 16384),
     "0.000646"),
    ("segment_offsets", lambda: seg_ops.segment_offsets(_sorted_ids(13188328), 685230),
     "0.0166"),
    ("segment_offsets", lambda: seg_ops.segment_offsets(_sorted_ids(61859328),
                                                        2449408), "0.0768"),
    ("attraction_sum", lambda: seg_ops.attraction_sum(
        _fake((16384, 2)), _fake(524288, torch.int32), _fake(524288),
        seg_ops.segment_layout(_sorted_ids(524288), 16384, sorted=True)), "0.00135"),
    ("attraction_sum", lambda: seg_ops.attraction_sum(
        _fake((685230, 2)), _fake(13188328, torch.int32), _fake(13188328),
        seg_ops.segment_layout(_sorted_ids(13188328), 685230, sorted=True)), "0.0356"),
    ("segment_sum_edges", lambda: seg_ops.segment_sum_edges(
        _fake((1132544, 2)), _fake(1132544, torch.int32), 248320), "0.00495"),
    ("segment_sum_edges", lambda: seg_ops.segment_sum_edges(
        _fake((61859328, 64)), _fake(61859328, torch.int32), 2449408), "4.99"),
    ("segment_sum_gather_bwd", lambda: seg_ops._sum_through(
        _fake((61859328, 64)), seg_ops.segment_layout(_fake(61859328, torch.int32), 2449408),
        "segment_sum_gather_bwd"), "4.99"),
    ("cms_update_keys", lambda: cms_ops.update(
        _fake((4, 6594)), _fake(685230, torch.int32), _fake(685230),
        cms_lib.CMSConfig(rows=4, cols=6594)), "0.00170"),
    ("cms_update", lambda: cms_ops.update_hashed(
        _fake((4, 6594)), _fake((4, 685230), torch.int32), _fake(685230)), "0.00415"),
    ("far_field", lambda: grid_ops.far_field(
        _fake((685230, 2)), _fake(685230), _fake(685230, torch.int32), _fake((4096, 2)),
        _fake(4096), 80.0), "0.545"),
]
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_layout_rules_give_the_type_and_its_bytes(dtype, monkeypatch):
    """K2's entries and K7's attraction on fake tensors of a half-width
    layout: the output in the layout's type (the card's call allocates it
    so) and the bytes at 2 an element (int32 ids and offsets at 4), the
    operations those of float32; nothing launches."""
    n, nl, e = 16384, 8192, 524288
    seen = []
    monkeypatch.setattr(build, "RULE_OBSERVERS", [lambda *a: seen.append(a)])
    launches = dict(build.LAUNCHES)
    with FakeTensorMode():
        f = rep_ops.repulsion(_fake((n, 2), dtype), _fake(n, dtype), 1.0, radii=_fake(n, dtype))
        fr = rep_ops.repulsion_rows(_fake((n, 2), dtype), _fake(n, dtype), nl, nl, 1.0,
                                    radii=_fake(n, dtype))
        fa = seg_ops.attraction_sum(_fake((n, 2), dtype), _fake(e, torch.int32),
                                    _fake(e, dtype),
                                    seg_ops.segment_layout(_sorted_ids(e), n, sorted=True))
    assert build.LAUNCHES == launches
    assert (f.dtype, tuple(f.shape)) == (dtype, (n, 2))
    assert (fr.dtype, tuple(fr.shape)) == (dtype, (nl, 2))
    assert (fa.dtype, tuple(fa.shape)) == (dtype, (n, 2))
    got = {name: (ops, nbytes) for name, ops, nbytes in seen}
    assert got["repulsion_nbody"] == (17 * n * n, n * 2 * 6)  # pos (2), mass, radii, out (2)
    assert got["repulsion_rows"] == (17 * nl * n, n * 2 * 4 + nl * 2 * 2)
    assert got["attraction_sum"] == (6 * e, e * (4 + 2) + n * (4 + 4 * 2))
    assert got["repulsion_nbody"][1] * 2 == rep_ops.repulsion_cost(n, True)[1]
    assert got["attraction_sum"][0] == seg_ops.attraction_sum_cost(n, e)[0]


# K6's rows: (entry, cost arguments, same-cell pairs of the row's input, its
# bound ms as printed). A rule on fake tensors cannot read the cells and
# counts every in-range band slot as a pair; the printed bounds count the
# pairs of the full path's converged layout, as chip_smoke.py's row log
# gives them (``same_cell_pairs=``).
NEAR_ROWS = [("near_field", (685230, 32, 0, 685230), 41714462, "0.00813"),
             ("near_field_rows", (685230, 32, 342615, 342615), 20857246, "0.00406")]


@pytest.mark.parametrize("row", range(len(BOUND_ROWS)),
                         ids=[f"{r[0]}-{r[2]}" for r in BOUND_ROWS])
def test_rule_costs_give_the_perf_table_bounds(row, monkeypatch):
    entry, call, printed = BOUND_ROWS[row]
    seen = []
    monkeypatch.setattr(build, "RULE_OBSERVERS", [lambda *a: seen.append(a)])
    with FakeTensorMode():
        call()
    (ops, nbytes), = [(o, b) for name, o, b in seen if name == entry]
    bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3
    assert float(f"{bound:.3g}") == float(printed), (entry, bound, printed)


def _bound_ms(ops, nbytes):
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3


@pytest.mark.parametrize("row", NEAR_ROWS, ids=[r[0] for r in NEAR_ROWS])
def test_near_field_costs_give_the_perf_table_bounds(row, monkeypatch):
    """K6's cost at the row's pairs gives PERF.md §6's bound; its rule, on
    fake tensors of the row's shapes, counts every in-range band slot as a
    pair, the bytes unchanged."""
    entry, (n, w, i0, nl), pairs, printed = row
    ops, nbytes = grid_ops.near_field_rows_cost(n, w, i0, nl, pairs)
    assert float(f"{_bound_ms(ops, nbytes):.3g}") == float(printed)
    seen = []
    monkeypatch.setattr(build, "RULE_OBSERVERS", [lambda *a: seen.append(a)])
    with FakeTensorMode():
        args = (_fake((n, 2)), _fake(n), _fake(n, torch.int32), 80.0, w)
        if entry == "near_field":
            grid_ops.near_field_sorted(*args)
        else:
            grid_ops.near_field_rows(*args, i0, nl)
    slots = ops - grid_ops.NEAR_OPS_PER_PAIR * pairs
    assert seen == [(entry, slots * (1 + grid_ops.NEAR_OPS_PER_PAIR), nbytes)]
    if entry == "near_field":
        assert slots == sum(2 * (n - k) for k in range(1, w + 1))


def _grid_layout_arch():
    arch = get_config("biggraphvis")
    return replace(arch, model=replace(arch.model, layout_repulsion="grid"))


def test_grid_layout_step_takes_the_k5_k6_rules(no_plain):
    """The grid form of a ``layout_berkstan``-shaped step on one rank,
    traced end to end on fake tensors: no plain version, and K5's and K6's
    rules counted once each with their costs; the step's outputs shaped as
    its inputs. (On a mesh: ``test_grid_layout_step_on_a_mesh``.)"""
    arch = _grid_layout_arch()
    shape = arch.shapes["layout_berkstan"]
    mesh = make_host_mesh(device="cpu")
    built = build_step(arch, shape, mesh)
    stats, _ = dryrun.trace_step(built, mesh, mesh.device)
    n, c, w = shape.n_nodes, arch.model.layout_grid_size ** 2, arch.model.layout_grid_window
    k = stats.kernels
    assert k["far_field"] == {"calls": 1, "operations": grid_ops.far_field_cost(n, c)[0],
                              "bytes": grid_ops.far_field_cost(n, c)[1]}
    ops, nbytes = grid_ops.near_field_cost(n, w)
    assert k["near_field"] == {"calls": 1, "operations": ops, "bytes": nbytes}
    assert k["segment_sum"]["calls"] == 1 and "repulsion_nbody" not in k


def test_grid_layout_step_on_a_mesh(sides):
    """The same step on (2, 2), as rank 0 of a fake world of four with
    every plain version refused (``tests/torch_dryrun_worker.py``): K5 on
    the rank's sorted rows, K6's row entry, and no whole K6."""
    arch = _grid_layout_arch()
    shape = arch.shapes["layout_berkstan"]
    n, c, w = shape.n_nodes, arch.model.layout_grid_size ** 2, arch.model.layout_grid_window
    nl = n // 4
    k = sides["port"]["grid_layout"]
    assert k["far_field"] == {"calls": 1, "operations": grid_ops.far_field_cost(nl, c)[0],
                              "bytes": grid_ops.far_field_cost(nl, c)[1]}
    ops, nbytes = grid_ops.near_field_rows_cost(n, w, 0, nl)
    assert k["near_field_rows"] == {"calls": 1, "operations": ops, "bytes": nbytes}
    assert "near_field" not in k


def test_gin_products_step_counts_its_k7_entries():
    """gin-tu ``ogb_products`` on a mesh of one: 20 sums (forward and remat
    recompute), 10 gather backwards and 2 layout builds a step, as the
    card's run counts its launches (PERF.md §6)."""
    mesh = make_host_mesh(device="cpu")
    arch = get_config("gin-tu")
    built = build_step(arch, arch.shapes["ogb_products"], mesh)
    stats, _ = dryrun.trace_step(built, mesh, mesh.device)
    calls = {k: v["calls"] for k, v in stats.kernels.items()}
    assert calls == {"segment_sum_edges": 20, "segment_sum_gather_bwd": 10,
                     "segment_offsets": 2}, calls
    assert stats.collective_calls == {}


# --------------------------------------------------------------------- CLI
CLI_CELLS = [("biggraphvis", "detect_berkstan", "single"), ("sasrec", "train_batch", "multi")]
SKIPPED = [(a, "long_500k", "both") for a in ("kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                                              "yi-6b", "mistral-large-123b")]


def test_cli_records_carry_the_reference_keys(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
                               "cpu", "--arch", a, "--shape", s, "--mesh", m, "--out",
                               str(tmp_path)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, s, m in CLI_CELLS + SKIPPED]
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, out[-3000:]
    recs = [json.loads(f.read_text()) for f in sorted(tmp_path.glob("*.json"))]
    assert len(recs) == len(CLI_CELLS) + 2 * len(SKIPPED)
    for rec in recs:
        if rec["status"] == "skipped":
            assert rec["skip_reason"] and rec["shape"] == "long_500k"
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert rec["n_devices"] == (512 if rec["mesh"] == "multi" else 256)
        assert rec["memory"]["argument_size_in_bytes"] >= 0
        assert set(rec["memory"]) == {"generated_code_size_in_bytes", "argument_size_in_bytes",
                                      "output_size_in_bytes", "alias_size_in_bytes",
                                      "temp_size_in_bytes"}
        assert "flops" in rec["cost"] and "bytes accessed" in rec["cost"]
        assert rec["hlo_dot_flops"] >= 0 and rec["collective_bytes"] >= 0
        assert rec["meta"].get("model_flops", 0) > 0
        mem = rec["memory"]
        assert rec["bytes_per_device"] == (mem["argument_size_in_bytes"]
                                           + mem["output_size_in_bytes"]
                                           + mem["temp_size_in_bytes"]
                                           - mem["alias_size_in_bytes"]) > 0
    by = {(r["arch"], r["shape"]): r for r in recs if r["status"] == "ok"}
    assert by["biggraphvis", "detect_berkstan"]["kernels"]["cms_update_keys"]["calls"] == 1
    sas = by["sasrec", "train_batch"]
    assert sas["hlo_dot_flops"] > 0 and sas["last_rank"]["rank"] == 511
    assert Path(dryrun.OUT_DIR).name == "dryrun_torch"
