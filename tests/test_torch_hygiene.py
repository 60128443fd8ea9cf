"""The port stands alone: every ``repro_torch`` module imports with ``jax``
and the reference package ``repro`` blocked, no file of the port names
either, ``chip_smoke.py`` imports neither, and the entry points refuse to
fall back to the CPU when no card is present."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any import of jax raises ImportError
sys.modules["repro"] = None    # so does any import of the reference package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for name in repro_torch.__all__:
    getattr(repro_torch, name)
sys.path.insert(0, {root!r})
import chip_smoke
bad = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
)
assert not bad, bad
print(" ".join(names))
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(root=str(ROOT))],
        capture_output=True, text=True, env=_env(), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # modules walked
    walked = set(out.stdout.split()[:-1])
    for name in ("repro_torch.serve.tiles", "repro_torch.obs.meters", "repro_torch.obs.cli",
                 "repro_torch.launch.serve", "repro_torch.launch.render_runner",
                 "repro_torch.launch.layout", "repro_torch.launch.stream_runner",
                 "repro_torch.resilience", "repro_torch.resilience.checkpoint",
                 "repro_torch.resilience.validate", "repro_torch.resilience.chaos",
                 "repro_torch.resilience.fault_tolerance", "repro_torch.sharding",
                 "repro_torch.sharding.rules", "repro_torch.sharding.collectives",
                 "repro_torch.launch.mesh", "repro_torch.launch.steps",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.biggraphvis", "repro_torch.configs.lm_archs",
                 "repro_torch.configs.gnn_archs", "repro_torch.configs.sasrec",
                 "repro_torch.models.param", "repro_torch.models.layers",
                 "repro_torch.models.transformer", "repro_torch.models.gnn",
                 "repro_torch.models.sasrec", "repro_torch.serve.engine",
                 "repro_torch.graph.sampling", "repro_torch.data.pipeline",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.compression", "repro_torch.train.train_loop",
                 "repro_torch.train.checkpoint", "repro_torch.train.fault_tolerance",
                 "repro_torch.launch.train", "repro_torch.sharding.params",
                 "repro_torch.launch.dryrun", "repro_torch.launch.op_analysis",
                 "repro_torch.core.prng", "repro_torch.core.forceatlas2"):
        assert name in walked, name


_BLOCKED_EXAMPLES = """
import importlib.util, pathlib, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
names = []
for path in sorted(pathlib.Path({root!r}, "examples").glob("*_torch.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path.stem)
bad = sorted(m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
assert not [m for m in bad if sys.modules[m] is not None], bad
print(" ".join(names))
"""


def test_torch_examples_import_without_jax_or_reference():
    """The port's examples (``examples/*_torch.py``) import no ``jax`` and
    nothing of the reference package."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_EXAMPLES.format(root=str(ROOT))],
                         capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(out.stdout.split()) == {
        "quickstart_torch", "stream_from_disk_torch", "gnn_fullbatch_torch",
        "rounds_series_torch", "serve_lm_torch", "train_lm_torch"}


def test_public_surface_covers_the_reference():
    import repro
    import repro.resilience
    import repro_torch
    import repro_torch.resilience

    assert set(repro.__all__) <= set(repro_torch.__all__)
    assert set(repro.resilience.__all__) <= set(repro_torch.resilience.__all__)


def test_mesh_surface_covers_the_reference():
    """``repro_torch.sharding`` and ``repro_torch.launch.mesh`` have at least
    the reference's public names (its ``sharding`` package and
    ``launch/mesh.py``), and the modules of the training mesh import
    neither ``jax`` nor the reference (run with both blocked)."""
    import importlib

    import repro.launch.mesh
    import repro.sharding
    import repro_torch.launch.mesh
    import repro_torch.sharding

    want = {n for n in dir(repro.sharding) if not n.startswith("_")} - {"rules"}
    assert want <= set(repro_torch.sharding.__all__), want - set(repro_torch.sharding.__all__)
    want = {n for n in dir(repro.launch.mesh)
            if not n.startswith("_") and n.startswith("make_")}
    assert want <= set(dir(repro_torch.launch.mesh)), want
    blocked = ("import sys\nsys.modules['jax'] = None\nsys.modules['repro'] = None\n"
               "import importlib\n"
               "for m in ('repro_torch.sharding', 'repro_torch.sharding.params', "
               "'repro_torch.sharding.rules', 'repro_torch.sharding.collectives', "
               "'repro_torch.launch.mesh', 'repro_torch.launch.steps', "
               "'repro_torch.models.layers', 'repro_torch.train.train_loop'):\n"
               "    importlib.import_module(m)\n"
               "bad = [m for m, mod in sys.modules.items() if mod is not None"
               " and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
               "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", blocked], capture_output=True, text=True,
                         env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert importlib.import_module("repro_torch.sharding").PROFILES == repro.sharding.PROFILES


def test_registry_has_the_reference_keys():
    import repro.configs
    import repro.graph
    import repro_torch.configs
    import repro_torch.graph

    assert list(repro_torch.configs.REGISTRY) == list(repro.configs.REGISTRY)
    assert repro_torch.configs.ASSIGNED == repro.configs.ASSIGNED
    cells = [(a.name, s.name) for a, s in repro_torch.configs.all_cells()]
    assert cells == [(a.name, s.name) for a, s in repro.configs.all_cells()]
    public = {n for n in dir(repro.graph) if not n.startswith("_")} - {
        "generators", "sampling", "utils", "EDGE_SENTINEL", "pad_to_multiple"}
    assert public <= set(repro_torch.graph.__all__), public - set(repro_torch.graph.__all__)


@pytest.mark.parametrize("pattern", [r"\bjax\b", r"(?<![\w/])repro\."])
def test_no_port_file_names_jax_or_the_reference(pattern):
    files = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu")]
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "examples").glob("*_torch.py"))]
    hits = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in files
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line, re.IGNORECASE)
    ]
    assert not hits, hits


def test_layout_inits_draw_from_the_seed_alone():
    """The FA2 inits take a seed and draw the reference's bits
    (``core/prng``): no torch generator, so no second way to draw."""
    src = (PKG / "core" / "forceatlas2.py").read_text()
    assert "Generator" not in src and "torch.rand" not in src
    assert "prng.uniform" in src


@pytest.mark.parametrize("module", ["models/param.py", "launch/train.py"])
def test_weights_draw_from_the_key_alone(module):
    """``init_params`` and the train launcher draw the reference's weights
    from a key (``core/prng``): no torch generator, so no second way to
    draw."""
    src = (PKG / module).read_text()
    assert "Generator" not in src and "torch.randn" not in src and "torch.rand" not in src
    assert "prng." in src


def test_device_none_raises_without_cuda(monkeypatch):
    import repro_torch
    from repro_torch.configs.lm_archs import smoke_lm
    from repro_torch.core import prng
    from repro_torch.graph.generators import planted_partition
    from repro_torch.models.param import init_params
    from repro_torch.models.transformer import param_specs
    from repro_torch.serve.engine import LMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges, _ = planted_partition(60, 3, 0.3, 0.02, seed=0)
    cfg = repro_torch.default_config(60, len(edges), 3, iterations=2)
    for call in (
        lambda: repro_torch.biggraphvis(edges, 60, cfg),
        lambda: repro_torch.layout(edges, np.ones(len(edges), np.float32),
                                   np.ones(60, np.float32), 60, cfg.layout),
        lambda: repro_torch.render_arrays(np.zeros((4, 2)), np.ones(4), np.zeros(4)),
        lambda: repro_torch.stream_pipeline(edges, 60, cfg.scoda, cfg.cms, 60, 64),
        lambda: repro_torch.full_layout_colored(edges, 60, cfg, iterations=2),
        lambda: LMEngine(smoke_lm(), init_params(prng.key(0), param_specs(smoke_lm()),
                                                 device="cpu"), 2, 8),
        lambda: init_params(prng.key(0), param_specs(smoke_lm())),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("launcher, argv", [
    ("serve", ["--nodes", "60", "--communities", "3", "--requests", "2"]),
    ("render_runner", ["--nodes", "60", "--communities", "3"]),
    ("layout", ["--edges", "synthetic:60:3"]),
    ("stream_runner", ["--nodes", "60", "--communities", "3",
                       "--checkpoint-dir", "ck"]),
    ("train", ["--arch", "gin-tu", "--steps", "2", "--ckpt-dir", "ck"]),
])
def test_launchers_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path, launcher, argv):
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{launcher}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())  # nothing written


def test_unported_knobs_raise_naming_the_roadmap(tmp_path):
    """No knob is left unported: the multi-device knobs (a mesh of one rank
    here; tests/test_torch_sharded.py runs several), checkpoint/resume and
    validated reads run, and each gives the unsharded labels."""
    import repro_torch
    from repro_torch.graph.generators import planted_partition
    from repro_torch.launch.mesh import make_stream_mesh
    from repro_torch.resilience import StreamCheckpointer, ValidationPolicy

    edges, _ = planted_partition(60, 3, 0.3, 0.02, seed=0)
    cfg = repro_torch.default_config(60, len(edges), 3, iterations=2)
    want = repro_torch.biggraphvis(edges, 60, cfg, device="cpu")
    mesh = make_stream_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    for scfg in (repro_torch.StreamConfig(mesh=mesh),
                 repro_torch.StreamConfig(shard_detect=True),
                 repro_torch.StreamConfig(mesh=mesh, shard_detect=True,
                                          shard_layout=True)):
        got = repro_torch.biggraphvis(edges, 60, cfg, scfg, device="cpu")
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(got.positions, want.positions)
        assert got.stream.devices == 1
    ck = StreamCheckpointer(str(tmp_path))
    for kwargs in ({"checkpoint": ck}, {"checkpoint": ck, "resume": True},
                   {"resume": str(tmp_path)}):
        got = repro_torch.biggraphvis(edges, 60, cfg, device="cpu", **kwargs)
        np.testing.assert_array_equal(got.labels, want.labels)
    assert ck.saves > 0
    got = repro_torch.biggraphvis(edges, 60, cfg, repro_torch.StreamConfig(
        chunk_size=64, validation=ValidationPolicy()), device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.stream.dropped_edges == 0 and got.stream.quarantined_chunk_ids == []


def test_cpu_tensors_take_the_plain_versions_and_meta_tensors_raise():
    """A wrapper takes the plain version only for CPU tensors; any other
    device is refused rather than moved."""
    from repro_torch.core import cms as cms_lib
    from repro_torch.kernels import build
    from repro_torch.kernels.cms import ops as cms_ops
    from repro_torch.kernels.grid import ops as grid_ops
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.kernels.raster import ops as raster_ops
    from repro_torch.kernels.repulsion import ops as rep_ops
    from repro_torch.kernels.segment import ops as seg_ops

    before = dict(build.LAUNCHES)
    # One counter per library, and one more for each library's other entry:
    # K1's generic scatter, K2's and K6's row ranges, K3's small-disk entry,
    # K7's layout entries (the layout build, the per-edge sum, the gather
    # backward, the fused attraction), K8's keys-in entry.
    extra = {"scatter_combine", "repulsion_rows", "near_field_rows", "count_disks",
             "segment_offsets", "segment_sum_edges", "segment_sum_gather_bwd",
             "attraction_sum", "cms_update_keys"}
    assert set(before) == set(build.KERNELS) | extra and len(before) == 17
    i = torch.zeros(4, dtype=torch.int32)
    f = torch.zeros(4)
    p = torch.zeros(4, 2)
    merge_ops.scatter_combine(i, i, i, f, 4)
    merge_ops.merge_place(i, i, i, f, i, i, i, f, 4)
    rep_ops.repulsion(p, f, 80.0)
    rep_ops.repulsion_rows(p, f, 1, 2, 80.0)
    raster_ops.count_scatter_into(i.clone(), i)
    raster_ops.count_disks_into(torch.zeros(11, 3, 3, dtype=torch.int32), f, f, f, i, 11)
    raster_ops.disk_accum(f, f, f, i, 11, 3, 3)
    raster_ops.disk_accum_into(torch.zeros(11, 3, 3, dtype=torch.int32), f, f, f, i, 11)
    grid_ops.far_field(p, f, i, p, f, 80.0)
    grid_ops.near_field_sorted(p, f, i, 80.0, 2)
    grid_ops.near_field_rows(p, f, i, 80.0, 2, 1, 2)
    seg_ops.segment_sum(p, i, 4)
    seg_ops.segment_sum_edges(p, i, 4)
    lay = seg_ops.segment_layout(i, 4)
    seg_ops.segment_sum_edges(p, lay, 4)
    seg_ops.attraction_sum(p, i, f, seg_ops.segment_layout(i, 4, sorted=True))
    x = p.clone().requires_grad_(True)
    seg_ops.segment_sum_edges(seg_ops.gather_rows(x, i), i, 4).sum().backward()
    seg_ops.segment_sum_edges(seg_ops.gather_rows(x, i, lay), lay, 4).sum().backward()
    cfg = cms_lib.CMSConfig(rows=2, cols=8)
    cms_ops.update(cms_lib.init_sketch(cfg), i, f, cfg)
    cms_ops.update_hashed(cms_lib.init_sketch(cfg), torch.zeros(2, 4, dtype=torch.int32), f)
    cms_lib.update(cms_lib.init_sketch(cfg), i, f, cfg)
    assert build.LAUNCHES == before  # no kernel launch counted on the CPU
    m = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rep_ops.repulsion(torch.zeros(4, 2, device="meta"), m, 80.0)
    with pytest.raises(ValueError, match="unsupported device"):
        rep_ops.repulsion_rows(torch.zeros(4, 2, device="meta"), m, 0, 2, 80.0)
    with pytest.raises(ValueError, match="unsupported device"):
        grid_ops.near_field_rows(torch.zeros(4, 2, device="meta"), m, i.to("meta"),
                                 80.0, 2, 0, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        seg_ops.segment_sum(torch.zeros(4, 3, device="meta"), i.to("meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        seg_ops.segment_sum_edges(torch.zeros(4, 3, device="meta"), i.to("meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        seg_ops.segment_layout(i.to("meta"), 4)
    with pytest.raises(ValueError, match="unsupported device"):
        seg_ops.attraction_sum(torch.zeros(4, 2, device="meta"), i.to("meta"), m,
                               seg_ops.segment_layout(i, 4, sorted=True))
    im = i.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        merge_ops.merge_place(im, im, im, m, im, im, im, m, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        raster_ops.disk_accum(m, m, m, im, 11, 3, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        cms_ops.update_hashed(torch.zeros(2, 8, device="meta"),
                              torch.zeros(2, 4, dtype=torch.int32, device="meta"), m)
    with pytest.raises(ValueError, match="unsupported device"):
        cms_lib.update(torch.zeros(2, 8, device="meta"), im, m, cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        raster_ops.count_disks_into(torch.zeros(11, 3, 3, dtype=torch.int32, device="meta"),
                                    m, m, m, im, 11)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Without CUDA the smoke exits non-zero and prints no result line; a
    directory holding only the script fails too, even where CUDA is (here:
    claimed) available."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    claim_cuda = (
        "import runpy, torch; torch.cuda.is_available = lambda: True; "
        f"runpy.run_path({str(alone)!r}, run_name='__main__')"
    )
    for cwd, cmd in ((ROOT, [str(ROOT / "chip_smoke.py")]), (tmp_path, ["-c", claim_cuda])):
        out = subprocess.run(
            [sys.executable, *cmd], cwd=cwd, capture_output=True,
            text=True, env=env if cwd == ROOT else {**env, "PYTHONPATH": ""},
            timeout=120,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
    assert "not found" in out.stderr
