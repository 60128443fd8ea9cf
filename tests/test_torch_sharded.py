"""The port's multi-device paths on the CPU: ``torch.distributed`` ranks
under gloo, D = 2 and D = 4, each a process of its own.

Every case mirrors one of ``tests/test_sharded_pipeline.py`` on the
reference test's graph (``planted_partition(768, 16, 0.3, 0.002, seed=11)``,
2 rounds, block 128, chunks of 256), or one of the resilience tests at
their sizes. The ranks run every case once per rank count
(``tests/torch_sharded_worker.py``, spawned by a module-scoped fixture);
the tests compare what each rank returned:

* with the port's single-rank run, bitwise, positions included (the
  sharded runs must be the same run);
* with the reference's single-device run (JAX on the CPU): integers
  bitwise, Q within 1e-6 and positions within 1e-4·max|pos|, the
  tolerances of ``tests/test_torch_pipeline.py``. The reference's own
  sharded runs fail (reference fault R2), so they are never the yardstick.
"""
import contextlib
import os
import pickle
import re
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro  # noqa: E402
import repro.resilience as jres  # noqa: E402
from repro.core import forceatlas2 as jfa2  # noqa: E402
from repro.core.cms import CMSConfig as JaxCMSConfig  # noqa: E402
from repro.core.scoda import ScodaConfig as JaxScodaConfig  # noqa: E402
from repro.core.stream import EdgeChunkStream as JaxEdgeChunkStream  # noqa: E402
from repro.core.stream import StreamConfig as JaxStreamConfig  # noqa: E402
from repro.core.stream import stream_pipeline as jax_stream_pipeline  # noqa: E402
from repro.graph.utils import mode_degree  # noqa: E402
from repro.kernels.grid.ref import bin_and_sort as jax_bin_and_sort  # noqa: E402
from repro.kernels.grid.ref import near_field_rows as jax_near_field_rows  # noqa: E402

import repro_torch  # noqa: E402
import torch_sharded_worker as W  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.kernels.grid import ops as grid_ops  # noqa: E402
from repro_torch.kernels.grid.ref import near_field_ref, near_field_rows  # noqa: E402
from repro_torch.kernels.repulsion import ops as rep_ops  # noqa: E402
from repro_torch.kernels.repulsion.ref import (  # noqa: E402
    repulsion_chunked,
    repulsion_chunked_rows,
)
from repro_torch.launch.mesh import StreamMesh, spawn_local  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    KillSwitch,
    SimulatedPreemption,
    StreamCheckpointer,
    ValidationPolicy,
)

ROOT = Path(__file__).resolve().parents[1]
ONE = StreamMesh(0, 1, torch.device("cpu"))
RANKS = (2, 4)
SPAWN_TIMEOUT = 240  # seconds: a rank that hangs fails the fixture


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint8) if a.dtype.kind == "f" else a


def _same(got: dict, want: dict, keys=None):
    """Every key of ``want`` bitwise in ``got`` (floats by their bits)."""
    for k in keys or want:
        if k in ("devices", "peak_local_bytes", "warnings"):
            continue
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


def _resilience_one(**kw):
    return W.resilience_run(None, **kw)


@contextlib.contextmanager
def _error_counters_kept():
    """The validated runs count into the process-global ``errors.*``
    counters; put them back, so that other tests in this process read their
    own."""
    from repro_torch.obs.metrics import ERROR_COUNTERS, REGISTRY

    kept = {name: REGISTRY.counter(name).value for name in ERROR_COUNTERS}
    try:
        yield
    finally:
        for name, value in kept.items():
            REGISTRY.counter(name).value = value


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The port's single-rank runs of every case, and the checkpoints the
    ranks resume from: one written by a single port rank, one by the
    reference, each killed in round 1 after a round-boundary save."""
    edges = W.graph()
    cfg = W.pipeline_cfg(edges)
    out = {}
    for agg in ("merge", "lexsort"):
        out[f"pipeline_{agg}"] = W.result_arrays(repro_torch.biggraphvis(
            edges, W.N, cfg, repro_torch.StreamConfig(chunk_size=256, agg_backend=agg),
            device="cpu"))
    out["pipeline_random"] = W.result_arrays(repro_torch.biggraphvis(
        edges, W.N, W.pipeline_cfg(edges, init="random"),
        repro_torch.StreamConfig(chunk_size=256), device="cpu"))
    out["fallback"] = W.result_arrays(repro_torch.biggraphvis(
        edges, W.N, W.pipeline_cfg(edges, block=81),
        repro_torch.StreamConfig(chunk_size=81), device="cpu"))
    out["resilience"] = _resilience_one()
    d = tmp_path_factory.mktemp("ckpt")
    kill = W.RE // W.RCHUNK + 8
    with pytest.raises(SimulatedPreemption):
        _resilience_one(checkpoint=StreamCheckpointer(str(d / "one"),
                                                      on_boundary=KillSwitch(kill)))
    redges, rscoda, rcms = W.resilience_inputs()
    jscoda = JaxScodaConfig(degree_threshold=8, rounds=W.RROUNDS, block_size=W.RBLOCK)
    assert config_from_reference(jscoda) == rscoda
    with pytest.raises(jres.SimulatedPreemption):
        jax_stream_pipeline(redges, W.RN, jscoda, JaxCMSConfig(rows=4, cols=256),
                            W.RS_CAP, W.RMAX_SE, JaxStreamConfig(chunk_size=W.RCHUNK),
                            checkpoint=jres.StreamCheckpointer(
                                str(d / "reference"), on_boundary=jres.KillSwitch(kill)))
    out["ckpt_dirs"] = {"one": str(d / "one"), "reference": str(d / "reference")}
    _, store = W.chaos_store(redges)
    with _error_counters_kept():
        out["chaos"] = _resilience_one(source=store, stream_cfg=repro_torch.StreamConfig(
            chunk_size=W.RCHUNK, validation=ValidationPolicy(retry_backoff_s=0.0)))
    return out


def _reference_run(init):
    """The reference's single-device run of the pipeline case (JAX)."""
    edges = W.graph()
    cfg = repro.default_config(W.N, len(edges), mode_degree(edges, W.N), rounds=2,
                               iterations=5, init=init)
    cfg = replace(cfg, scoda=replace(cfg.scoda, block_size=128))
    assert config_from_reference(cfg) == W.pipeline_cfg(edges, init=init)
    scfg = JaxStreamConfig(chunk_size=256)
    res = repro.biggraphvis(edges, W.N, cfg, scfg)
    stream = JaxEdgeChunkStream(edges, W.N, 256, block_size=128)
    chunk_b = stream.chunk_bytes * stream.inflight_buffers(scfg.prefetch)
    return res, chunk_b


@pytest.fixture(scope="module")
def reference():
    return _reference_run("degree")


@pytest.fixture(scope="module")
def reference_random():
    return _reference_run("random")


@pytest.fixture(scope="module", params=RANKS, ids=lambda d: f"D{d}")
def ranks(request, single, tmp_path_factory):
    """Every case on D ranks: a list of the ranks' results."""
    d = request.param
    out_dir = tmp_path_factory.mktemp(f"ranks{d}")
    ckpt_in = {}
    for name, src in single["ckpt_dirs"].items():  # a fresh copy for each D
        ckpt_in[name] = shutil.copytree(src, out_dir / f"in_{name}")
    spawn_local(W.run_all, d, device="cpu", init_file=str(out_dir / "store"),
                args=(str(out_dir), {k: str(v) for k, v in ckpt_in.items()}),
                timeout=SPAWN_TIMEOUT)
    got = []
    for r in range(d):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.mark.parametrize("agg", ["merge", "lexsort", "random"])
def test_sharded_pipeline_matches_one_rank_bitwise(ranks, single, agg):
    """Each aggregation backend from the degree init, and "random": the
    merge backend from the default init."""
    want = single[f"pipeline_{agg}"]
    for got in ranks:
        res = got[f"pipeline_{agg}"]
        _same(res, want)
        assert res["devices"] == len(ranks)
        assert res["peak_local_bytes"] < res["peak_device_bytes"]


def _matches_reference(res, want):
    """Integers bitwise against the reference's single-device run; Q and
    positions within tests/test_torch_pipeline.py's tolerances."""
    for k, ref in (("labels", want.labels), ("sizes", want.sizes),
                   ("groups", want.groups), ("sg_edges", want.supergraph.edges),
                   ("sg_weights", want.supergraph.weights)):
        assert np.array_equal(res[k], np.asarray(ref)), k
    assert (res["n_supernodes"], res["n_superedges"]) == (want.n_supernodes,
                                                           want.n_superedges)
    assert abs(res["modularity"] - want.modularity) <= 1e-6
    scale = np.abs(want.positions).max()
    np.testing.assert_allclose(res["positions"], want.positions, rtol=0,
                               atol=1e-4 * scale)


def test_sharded_pipeline_matches_the_reference(ranks, reference):
    want, _ = reference
    for got in ranks:
        _matches_reference(got["pipeline_merge"], want)


def test_sharded_pipeline_from_the_default_init_matches_the_reference(ranks,
                                                                     reference_random):
    """The same from the default "random" init: the ranks start from the
    reference's draw."""
    want, _ = reference_random
    for got in ranks:
        _matches_reference(got["pipeline_random"], want)


def test_layout_start_is_the_reference_start_on_every_rank(ranks):
    """The default init on each rank: bitwise the one-rank start and the
    reference's (the start ``layout`` draws when given no ``pos0``)."""
    edges = W.graph()[:512]
    mass = np.bincount(edges[:, 0], minlength=W.N).astype(np.float32) + 1
    one = fa2.initial_positions(torch.as_tensor(edges), torch.as_tensor(mass), W.N,
                                fa2.FA2Config()).numpy()
    want = np.asarray(jfa2._initial_positions_jit(jnp.asarray(edges), jnp.asarray(mass),
                                                  W.N, jfa2.FA2Config()))
    assert np.array_equal(_bits(one), _bits(want))
    for got in ranks:
        assert np.array_equal(_bits(got["start"]), _bits(one))


def test_peak_local_bytes_is_the_reference_analytic(ranks, reference):
    """State replicated, chunk buffers 1/D: the reference's
    ``_account_pass_peaks(devices=D)`` from its own single-device peak."""
    want, chunk_b = reference
    d = len(ranks)
    for got in ranks:
        res = got["pipeline_merge"]
        assert res["peak_device_bytes"] == want.stream.peak_device_bytes
        assert res["peak_local_bytes"] == (want.stream.peak_device_bytes - chunk_b
                                           + chunk_b // d)


def test_divisibility_fallback_is_silent_and_identical(ranks, single):
    for got in ranks:
        res = got["fallback"]
        _same(res, single["fallback"])
        assert res["devices"] == 1
        assert res["warnings"] == []


@pytest.mark.parametrize("rep", ["exact", "grid", "adaptive"])
def test_layout_sharded_matches_layout_bitwise(ranks, rep):
    edges = torch.as_tensor(W.graph()[:512])
    w = torch.ones(edges.shape[0])
    mass = torch.zeros(W.N).index_add_(0, edges[:, 0].long(), torch.ones(edges.shape[0])) + 1
    if rep == "adaptive":
        cfg = fa2.FA2Config(iterations=30, repulsion="grid", grid_size=8, grid_window=8,
                            grid_rebuild=2, stop_tolerance=0.5, min_iterations=3,
                            nan_guard=True)
    else:
        cfg = fa2.FA2Config(iterations=4, repulsion=rep, grid_size=8, grid_window=8)
    pos, trace, it = fa2.layout(edges, w, mass, W.N, cfg, device="cpu")
    for got in ranks:
        gp, gt, git = got[f"layout_{rep}"]
        assert np.array_equal(_bits(gp), _bits(pos.numpy()))
        assert np.array_equal(_bits(gt), _bits(trace.numpy()))
        assert git == it
    if rep == "adaptive":
        assert 3 <= it < cfg.iterations  # the stop engaged, on every rank alike


def test_layout_sharded_fallbacks_warn_once_with_the_reference_reasons(ranks):
    d = len(ranks)
    small = torch.tensor([[0, 1], [1, 2], [2, 3]], dtype=torch.int32)
    want99, _, _ = fa2.layout(small, torch.ones(3), torch.ones(99), 99,
                              fa2.FA2Config(iterations=2), device="cpu")
    for got in ranks:
        (p1, _, w1), (p2, _, w2), (p3, dt3, w3) = got["layout_fallbacks"]
        assert w1 == [f"layout_sharded: falling back to single-device layout "
                      f"(n=99 does not divide evenly over {d} devices)"]
        assert w2 == []  # warn-once
        assert np.array_equal(_bits(p1), _bits(want99.numpy()))
        assert np.array_equal(_bits(p2), _bits(want99.numpy()))
        assert len(w3) == 1 and "float32" in w3[0] and "bfloat16" in w3[0]
        assert dt3 == "torch.bfloat16"
    cfg = fa2.FA2Config(repulsion="grid", dtype="bfloat16")
    mesh = StreamMesh(0, d, torch.device("cpu"))
    assert "float32" in fa2._sharded_fallback_reason(W.N, cfg, mesh)
    assert fa2._sharded_fallback_reason(W.N, fa2.FA2Config(repulsion="grid"), mesh) is None
    assert fa2._sharded_fallback_reason(W.N, cfg, ONE) == "mesh is trivial (1 device)"
    assert "no sharded form" in fa2._sharded_fallback_reason(
        W.N, fa2.FA2Config(repulsion="grid_dense"), mesh)


def test_layout_sharded_without_a_mesh_is_layout_and_silent(recwarn):
    edges = torch.tensor([[0, 1], [1, 2], [2, 3]], dtype=torch.int32)
    cfg = fa2.FA2Config(iterations=2)
    want, _, _ = fa2.layout(edges, torch.ones(3), torch.ones(8), 8, cfg, device="cpu")
    got, _, _ = fa2.layout_sharded(edges, torch.ones(3), torch.ones(8), 8, cfg, None,
                                   device="cpu")
    assert torch.equal(got, want)
    assert len(recwarn) == 0


def test_runner_put_pads_non_divisible_chunks(ranks, single):
    d = len(ranks)
    odd = np.asarray(W.graph()[: d + 1], np.int32)
    for r, got in enumerate(ranks):
        put = got["put"]
        # Before run() there is no sentinel: the chunk is placed whole.
        assert np.array_equal(put["before"], odd)
        after = put["after"]
        assert after.shape[0] % d == 0 and after.shape[0] > len(odd)
        assert np.array_equal(after[: len(odd)], odd)
        assert (after[len(odd):] == W.N).all()  # the padding is trash rows
        per = after.shape[0] // d
        assert np.array_equal(put["placed"], after[r * per:(r + 1) * per])
        # End to end at a chunk size no rank count divides: bitwise the
        # unsharded run (the port's chunks mode is placement only).
        _same(put["chunks"], single["pipeline_merge"],
              keys=["labels", "sizes", "sg_edges", "sg_weights", "modularity"])


def test_row_slices_of_the_chunked_repulsion_are_bitwise():
    """Row slices of the chunked j-scan equal the full run bitwise (chunk 64
    forces several j-chunks and a ragged tail), through the plain row form
    and through ``repulsion_rows`` (the dense form at n ≤ 2048)."""
    rng = np.random.default_rng(0)
    for n, chunk in ((200, 64), (3000, 1024)):
        pos = torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float32)
        mass = torch.tensor(rng.uniform(0.5, 2.0, size=n), dtype=torch.float32)
        radii = torch.tensor(rng.uniform(0.1, 1.0, size=n), dtype=torch.float32)
        full = repulsion_chunked(pos, mass, 9.0, radii=radii, chunk=chunk)
        whole = rep_ops.repulsion(pos, mass, 9.0, radii=radii)
        for i0, nl in ((0, n // 4), (n // 4, n // 4), (n - 50, 50), (64, 8), (n - 1, 1)):
            part = repulsion_chunked_rows(pos, mass, i0, nl, 9.0, radii=radii, chunk=chunk)
            assert torch.equal(part.view(torch.int32), full[i0:i0 + nl].view(torch.int32))
            rows = rep_ops.repulsion_rows(pos, mass, i0, nl, 9.0, radii=radii)
            assert torch.equal(rows.view(torch.int32), whole[i0:i0 + nl].view(torch.int32))
    with pytest.raises(ValueError, match="outside"):
        rep_ops.repulsion_rows(pos, mass, n - 4, 8, 9.0)


def test_near_field_rows_is_the_full_near_field_and_the_reference():
    """The port's halo row form equals the same rows of its full banded near
    field bitwise (through the wrapper too), and the reference's
    ``near_field_rows`` within the grid fields' stated tolerance (its
    compiled code may fuse d² into an FMA): 1e-5 of each row's Σ|f_ij|."""
    rng = np.random.default_rng(1)
    n, w, kr = 160, 16, 7.0
    pos = torch.tensor(rng.uniform(-10, 10, size=(n, 2)), dtype=torch.float32)
    mass = torch.tensor(rng.uniform(0.5, 2.0, size=n), dtype=torch.float32)
    jcell, jorder = jax_bin_and_sort(pos.numpy(), 4)
    cell, order = grid_ops.bin_and_sort(pos, 4)
    assert np.array_equal(cell.numpy(), np.asarray(jcell))
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    idx = order.long()
    pos_s, mass_s, cell_s = pos[idx], mass[idx], cell[idx]
    full = near_field_ref(pos_s, mass_s, cell_s, kr, w)
    scale = torch.zeros(n, 2)
    for k in range(-w, w + 1):  # Σ_j |f_ij| per row and axis
        j = torch.arange(n) + k
        ok = (j >= 0) & (j < n) & (k != 0)
        jj = j.clamp(0, n - 1)
        d = pos_s - pos_s[jj]
        d2 = (d * d).sum(1)
        mag = torch.where(ok & (cell_s[jj] == cell_s), kr * mass_s * mass_s[jj]
                          / torch.clamp(d2, min=1e-4), 0.0)
        scale += (mag[:, None] * d).abs()
    for i0, nl in ((0, 40), (40, 40), (120, 40), (8, 16), (159, 1)):
        part = near_field_rows(pos_s, mass_s, cell_s, kr, w, i0, nl)
        assert torch.equal(part.view(torch.int32), full[i0:i0 + nl].view(torch.int32))
        wrapped = grid_ops.near_field_rows(pos_s, mass_s, cell_s, kr, w, i0, nl)
        assert torch.equal(wrapped, part)
        ref = np.asarray(jax_near_field_rows(pos_s.numpy(), mass_s.numpy(),
                                             cell_s.numpy(), kr, w, i0, nl))
        err = np.abs(part.numpy() - ref)
        assert (err <= 1e-5 * scale[i0:i0 + nl].numpy() + 1e-30).all()


def test_checkpoints_resume_across_rank_counts(ranks, single):
    """One rank's and the reference's checkpoints resume on D ranks; D
    ranks' checkpoint resumes on one rank; all bitwise the uninterrupted
    run."""
    want = single["resilience"]
    keys = ["labels", "gdeg", "sg_edges", "sg_weights", "sizes", "sg_labels", "q"]
    for got in ranks:
        for name in ("one", "reference"):
            res = got[f"resume_{name}"]
            assert res["resumed_at"] == "detect:r1:c0", name
            assert res["devices"] == len(ranks)
            _same(res, want, keys)
    written = ranks[0]["written"]
    assert all(g["written"]["killed"] for g in ranks)
    assert [g["written"]["saves"] for g in ranks] == [1] * len(ranks)
    back = _resilience_one(checkpoint=StreamCheckpointer(written["dir"]), resume=True)
    assert back["resumed_at"] == "detect:r1:c0"
    _same(back, want, keys)


def test_sigterm_to_one_rank_stops_every_rank_at_one_boundary(ranks, single):
    # Rank 1 signalled itself in its 40th boundary hook; at the next boundary
    # every rank saves and stops, before its 41st hook.
    stops = [g["sigterm"]["stopped_after"] for g in ranks]
    assert stops == [40] * len(ranks)
    assert [g["sigterm"]["saves"] for g in ranks] == [2] * len(ranks)
    back = _resilience_one(checkpoint=StreamCheckpointer(ranks[0]["sigterm"]["dir"]),
                           resume=True)
    assert back["resumed_at"] == "detect:r1:c9"
    _same(back, single["resilience"], ["labels", "gdeg", "sg_edges", "sg_weights", "q"])


def test_validated_run_accounts_alike_on_every_rank(ranks, single):
    want = single["chaos"]
    assert want["quarantined"] == [9] and want["dropped"] > 0 and want["retries"] > 0
    for got in ranks:
        res = got["chaos"]
        for k in ("retries", "quarantined", "dropped"):
            assert res[k] == want[k], k
        _same(res, want, ["labels", "gdeg", "sg_edges", "sg_weights", "q"])
        assert res["injected"] == ranks[0]["chaos"]["injected"]
        assert res["devices"] == len(ranks)


def test_stream_runner_shard_all_under_torch_distributed_run(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.stream_runner",
           "--shard", "all", "--device", "cpu", "--nodes", "600", "--communities", "6",
           "--chunk", "512", "--block-size", "128", "--iterations", "5",
           "--checkpoint-dir", str(tmp_path / "ck")]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=180,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "streamed == one-shot: True" in out.stdout
    assert re.search(r"devices=2\b", out.stdout)
    assert out.stdout.count("streamed == one-shot") == 1  # rank 0 reports


def test_a_reference_mesh_converts_to_none():
    """A reference config's mesh is a JAX device mesh, meaningless to the
    port: it converts to None, and the shard flags stay as they were."""
    got = config_from_reference(JaxStreamConfig(chunk_size=512, mesh=object(),
                                                shard_detect=True, shard_layout=True))
    assert got.mesh is None and got.shard_detect and got.shard_layout
    assert got.chunk_size == 512
