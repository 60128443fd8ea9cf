"""The port's fault tolerance (``repro_torch.resilience`` and the stream
engine's hooks) on the CPU against the reference package.

Every result is held bitwise against a *trusting in-memory* run of the
reference on the equivalent edge array (labels, graph degrees, the
supergraph and Q): the reference's validated and disk-backed runs go
through its faulty staging ring and are never the yardstick. Checkpoint
files are the reference's format, so each package resumes from what the
other wrote.
"""
import hashlib
import json
import os
import signal
import tempfile

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.resilience as jres  # noqa: E402
from repro.core import forceatlas2 as jfa2  # noqa: E402
from repro.core.cms import CMSConfig as JaxCMSConfig  # noqa: E402
from repro.core.scoda import ScodaConfig as JaxScodaConfig  # noqa: E402
from repro.core.stream import StreamConfig as JaxStreamConfig  # noqa: E402
from repro.core.stream import stream_pipeline as jax_stream_pipeline  # noqa: E402

import repro_torch  # noqa: E402
import repro_torch.resilience as res  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import forceatlas2 as fa2  # noqa: E402
from repro_torch.core.stream import StreamConfig, StreamStats, stream_pipeline  # noqa: E402
from repro_torch.data.edge_store import write_npy  # noqa: E402
from repro_torch.obs.metrics import (  # noqa: E402
    ERROR_COUNTERS,
    REGISTRY,
    MetricsRegistry,
    ensure_error_counters,
)

# The reference's test sizes: 32 chunks a pass × (2 detect passes + 1
# supergraph pass) = 96 chunk boundaries to kill at.
N, E, CHUNK, ROUNDS, BLOCK = 240, 2000, 64, 2, 32
N_CHUNKS = -(-E // CHUNK)
N_BOUNDARIES = (ROUNDS + 1) * N_CHUNKS
JSCODA = JaxScodaConfig(degree_threshold=8, rounds=ROUNDS, block_size=BLOCK)
JCMS = JaxCMSConfig(rows=4, cols=256)
SCODA, CMS = config_from_reference(JSCODA), config_from_reference(JCMS)
S_CAP, MAX_SE = 512, 2048
# The reference's kill points: first chunk, round boundary, mid-round,
# supergraph pass, last boundary.
KILL_POINTS = [0, N_CHUNKS - 1, N_CHUNKS + 15, ROUNDS * N_CHUNKS + 5, N_BOUNDARIES - 1]
# Kill/resume runs keep every checkpoint: pruning unlinks files, which is
# slow on some filesystems, and it has tests of its own.
KEEP_ALL = N_BOUNDARIES + 1


def _edges():
    return np.random.default_rng(7).integers(0, N, (E, 2), dtype=np.int32)


def _run(source, checkpoint=None, resume=False, stream_cfg=None):
    return stream_pipeline(source, N, SCODA, CMS, S_CAP, MAX_SE,
                           stream_cfg or StreamConfig(chunk_size=CHUNK),
                           checkpoint=checkpoint, resume=resume, device="cpu")


def _jax_run(edges, checkpoint=None, resume=False, chunk=CHUNK):
    """The reference's trusting in-memory run."""
    return jax_stream_pipeline(edges, N, JSCODA, JCMS, S_CAP, MAX_SE,
                               JaxStreamConfig(chunk_size=chunk),
                               checkpoint=checkpoint, resume=resume)


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _digest(labels, gdeg, sg) -> str:
    """The reference test suite's digest without Q, over host copies of
    either package's outputs."""
    h = hashlib.sha256()
    for a in (labels, gdeg, sg.edges, sg.weights, sg.sizes, sg.labels):
        h.update(_host(a).tobytes())
    return h.hexdigest()


_WANT: dict = {}


def _want(edges):
    """The uninterrupted trusting in-memory runs on ``edges``, cached per
    array: the reference's digest and Q, and the port's Q."""
    key = hashlib.sha256(edges.tobytes()).hexdigest()
    if key not in _WANT:
        labels, gdeg, sg, q, _ = _jax_run(edges)
        _WANT[key] = (_digest(labels, gdeg, sg), float(q), float(_run(edges)[3]))
    return _WANT[key]


def _check(out, edges=None, q_from="port"):
    """``out`` (a stream run's first four outputs) equals the uninterrupted
    trusting run on ``edges``: labels, graph degrees and the supergraph
    bitwise against the reference's; Q bitwise against the same package's
    uninterrupted run and within 1e-6 of the reference's (the two packages
    sum the float32 modularity terms in different orders)."""
    digest, jq, tq = _want(_edges() if edges is None else edges)
    labels, gdeg, sg, q = out[:4]
    assert _digest(labels, gdeg, sg) == digest
    q = float(_host(q))
    assert q == (tq if q_from == "port" else jq)
    assert abs(q - jq) <= 1e-6


# ------------------------------------------------------ checkpoint mechanics


def test_checkpoint_atomic_roundtrip_and_prune(tmp_path):
    d = str(tmp_path)
    tree = {"com": torch.arange(10, dtype=torch.int32),
            "deg": np.ones(10, dtype=np.int32)}
    for step in range(1, 6):
        res.save(d, step, tree, extra={"phase": "detect", "chunk": step}, keep=2)
    assert res.latest_step(d) == 5
    kept = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert kept == ["step_00000004.npz", "step_00000005.npz"]
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
    arrays, meta = res.load_arrays(d, 5)
    np.testing.assert_array_equal(arrays["com"], np.arange(10, dtype=np.int32))
    np.testing.assert_array_equal(arrays["deg"], tree["deg"])
    assert arrays["com"].dtype == np.int32
    assert meta["chunk"] == 5 and meta["phase"] == "detect"


def test_restore_latest_valid_walks_back_past_corruption(tmp_path):
    d = str(tmp_path)
    res.save(d, 1, {"x": np.arange(3)}, extra={"chunk": 1})
    res.save(d, 2, {"x": np.arange(4)}, extra={"chunk": 2})
    bad = tmp_path / "step_00000002.npz"
    bad.write_bytes(b"not an npz at all")  # post-rename bit-rot
    arrays, meta = res.restore_latest_valid(d)
    assert meta["step"] == 1 and len(arrays["x"]) == 3
    assert not bad.exists()
    assert not (tmp_path / "step_00000002.npz.meta.json").exists()
    assert res.restore_latest_valid(str(tmp_path / "empty")) is None


def test_restore_latest_valid_predicate_walks_back(tmp_path):
    d = str(tmp_path)
    res.save(d, 1, {"x": np.arange(3)}, extra={"chunk": 1})
    res.save(d, 2, {"x": np.arange(4)}, extra={"chunk": 2})
    (tmp_path / "step_00000002.npz.meta.json").unlink()
    arrays, meta = res.restore_latest_valid(d, valid=lambda a, m: "chunk" in m)
    assert meta["step"] == 1 and meta["chunk"] == 1
    assert not (tmp_path / "step_00000002.npz").exists()


def test_prune_removes_orphaned_meta(tmp_path):
    d = str(tmp_path)
    res.save(d, 1, {"x": np.arange(3)}, extra={"chunk": 1}, keep=2)
    orphan = tmp_path / "step_00000099.npz.meta.json"
    orphan.write_text("{}")
    res.save(d, 2, {"x": np.arange(3)}, extra={"chunk": 2}, keep=2)
    assert not orphan.exists()
    assert res.latest_step(d) == 2  # discovery keys off .npz, never the meta


def test_checkpointer_seq_seeded_on_restore(tmp_path):
    d = str(tmp_path)
    ck = res.StreamCheckpointer(d, every_chunks=1, keep=3)
    for i in range(5):
        ck.boundary("detect", 0, i, False, lambda: {"x": torch.arange(3)})
    assert res.latest_step(d) == 5 and ck.saves == 5 and ck.last_bytes == 24
    ck2 = res.StreamCheckpointer(d, every_chunks=1, keep=3)
    found = ck2.restore_latest()
    assert found is not None and found[1]["step"] == 5
    ck2.boundary("detect", 0, 5, False, lambda: {"x": torch.arange(3)})
    assert res.latest_step(d) == 6  # not pruned on arrival under steps 3..5


def test_checkpointer_payload_is_lazy(tmp_path):
    """A boundary that does not save never calls the payload."""
    calls = []
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=0)
    for last in (False, False, True):
        ck.boundary("detect", 0, 1, last, lambda: calls.append(1) or {"x": np.arange(2)})
    assert len(calls) == 1 and ck.saves == 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_files_read_across_packages(tmp_path, writer):
    tree = {"com": np.arange(7, dtype=np.int32), "w": np.linspace(0, 1, 5, dtype=np.float32),
            "n": np.int32(3), "nested": [np.ones(2, np.int64), {"b": np.zeros(3, np.uint8)}]}
    save = jres.save if writer == "reference" else res.save
    load = res.load_arrays if writer == "reference" else jres.load_arrays
    save(str(tmp_path), 4, tree, extra={"phase": "supergraph", "round": 0, "chunk": 9})
    arrays, meta = load(str(tmp_path), 4)
    assert meta == {"step": 4, "phase": "supergraph", "round": 0, "chunk": 9}
    assert sorted(arrays) == ["com", "n", "nested/0", "nested/1/b", "w"]
    for key, want in (("com", tree["com"]), ("w", tree["w"]), ("n", tree["n"]),
                      ("nested/0", tree["nested"][0]), ("nested/1/b", tree["nested"][1]["b"])):
        assert arrays[key].dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(arrays[key], want)
    like = {"com": torch.zeros(7, dtype=torch.int32), "w": torch.zeros(5),
            "n": torch.zeros((), dtype=torch.int32),
            "nested": (torch.zeros(2, dtype=torch.int64), {"b": torch.zeros(3, dtype=torch.uint8)})}
    got, meta2 = res.restore(str(tmp_path), 4, like)
    assert meta2 == meta and isinstance(got["nested"], tuple)
    assert torch.equal(got["com"], torch.arange(7, dtype=torch.int32))
    assert torch.equal(got["nested"][1]["b"], torch.zeros(3, dtype=torch.uint8))
    with pytest.raises(ValueError, match="shape"):
        res.restore(str(tmp_path), 4, {"com": torch.zeros(6, dtype=torch.int32)})


def test_bfloat16_is_stored_as_the_reference_stores_it(tmp_path):
    t = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    res.save(str(tmp_path), 1, {"t": t})
    arrays, _ = res.load_arrays(str(tmp_path), 1)
    assert arrays["t"].dtype == np.uint16  # the reference's bfloat16 storage
    got, _ = res.restore(str(tmp_path), 1, {"t": torch.zeros(3, dtype=torch.bfloat16)})
    assert got["t"].dtype == torch.bfloat16 and torch.equal(got["t"], t)


@pytest.mark.parametrize("case", ["scoda", "cms", "stream", "defaults"])
def test_config_fingerprint_matches_reference(case):
    jcfg = {
        "scoda": {"scoda": JSCODA},
        "cms": {"cms": JCMS},
        "stream": dict(n_nodes=N, n_edges=E, chunk_size=CHUNK, scoda=JSCODA, cms=JCMS,
                       s_cap=S_CAP, max_super_edges=MAX_SE, agg_backend="merge",
                       with_modularity=True),
        "defaults": {"scoda": JaxScodaConfig(4), "cms": JaxCMSConfig()},
    }[case]
    tcfg = {k: config_from_reference(v) if hasattr(v, "__dataclass_fields__") else v
            for k, v in jcfg.items()}
    for k, v in tcfg.items():
        assert repr(v) == repr(jcfg[k]), k
    assert res.config_fingerprint(**tcfg) == jres.config_fingerprint(**jcfg)


def test_resilience_surface_covers_the_reference():
    assert set(jres.__all__) <= set(res.__all__)
    for name in res.__all__:
        getattr(res, name)
    fields = {f for f in StreamStats.__dataclass_fields__}
    assert {"retries", "quarantined_chunks", "quarantined_chunk_ids", "dropped_edges",
            "resumed_at"} <= fields


# ----------------------------------------------------- kill/resume identity


def _kill_then_resume(d, kill_at, edges=None):
    edges = _edges() if edges is None else edges
    ks = res.KillSwitch(kill_at)
    ck = res.StreamCheckpointer(d, every_chunks=1, keep=KEEP_ALL, on_boundary=ks)
    with pytest.raises(res.SimulatedPreemption):
        _run(edges, checkpoint=ck)
    assert ks.fired and ck.saves > 0
    return _run(edges, checkpoint=res.StreamCheckpointer(d, every_chunks=1, keep=KEEP_ALL),
                resume=True)


@pytest.mark.parametrize("kill_at", KILL_POINTS)
def test_kill_and_resume_bit_identical(tmp_path, kill_at):
    labels, gdeg, sg, q, stats = _kill_then_resume(str(tmp_path), kill_at)
    assert stats.resumed_at
    _check((labels, gdeg, sg, q))


@settings(max_examples=6, deadline=None)
@given(st.integers(0, N_BOUNDARIES - 1))
def test_kill_and_resume_property(kill_at):
    """Every chunk boundary is a safe preemption point: the cadence saves
    exactly at the killed boundary, and the resume from it matches."""
    with tempfile.TemporaryDirectory() as d:
        ks = res.KillSwitch(kill_at)
        ck = res.StreamCheckpointer(d, every_chunks=kill_at + 1, on_boundary=ks)
        with pytest.raises(res.SimulatedPreemption):
            _run(_edges(), checkpoint=ck)
        assert ks.fired and ck.saves == 1
        out = _run(_edges(), resume=d)
        assert out[4].resumed_at
        _check(out)


def test_resume_passes_count_what_is_left(tmp_path):
    """A run resumed at the start of round 1 streams one detect pass and
    the supergraph pass."""
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=0,
                                on_boundary=res.KillSwitch(N_CHUNKS + 3))
    with pytest.raises(res.SimulatedPreemption):
        _run(_edges(), checkpoint=ck)
    *out, stats = _run(_edges(), checkpoint=res.StreamCheckpointer(str(tmp_path)), resume=True)
    assert stats.resumed_at == "detect:r1:c0"
    assert stats.passes == ROUNDS - 1 + 1 and stats.chunks == ROUNDS * N_CHUNKS
    _check(out)


@pytest.mark.parametrize("kill_at", [N_CHUNKS + 15, ROUNDS * N_CHUNKS + 5])
def test_reference_killed_port_resumes(tmp_path, kill_at):
    ck = jres.StreamCheckpointer(str(tmp_path), every_chunks=1, keep=KEEP_ALL,
                                 on_boundary=jres.KillSwitch(kill_at))
    with pytest.raises(jres.SimulatedPreemption):
        _jax_run(_edges(), checkpoint=ck)
    labels, gdeg, sg, q, stats = _run(_edges(), resume=str(tmp_path))
    assert stats.resumed_at
    _check((labels, gdeg, sg, q))


@pytest.mark.parametrize("kill_at", [N_CHUNKS + 15, ROUNDS * N_CHUNKS + 5])
def test_port_killed_reference_resumes(tmp_path, kill_at):
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, keep=KEEP_ALL,
                                on_boundary=res.KillSwitch(kill_at))
    with pytest.raises(res.SimulatedPreemption):
        _run(_edges(), checkpoint=ck)
    labels, gdeg, sg, q, stats = _jax_run(_edges(), resume=str(tmp_path))
    assert stats.resumed_at
    _check((labels, gdeg, sg, q), q_from="reference")


def test_resume_layout_bit_identical(tmp_path):
    """Through ``biggraphvis``: the resumed run's positions equal the
    uninterrupted port run's byte for byte on the CPU."""
    edges = _edges()
    cfg = repro_torch.default_config(N, E, 8, rounds=ROUNDS, iterations=5, init="degree")
    from dataclasses import replace

    cfg = replace(cfg, scoda=replace(cfg.scoda, block_size=BLOCK))
    scfg = StreamConfig(chunk_size=CHUNK)
    want = repro_torch.biggraphvis(edges, N, cfg, scfg, device="cpu")
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, keep=KEEP_ALL,
                                on_boundary=res.KillSwitch(40))
    with pytest.raises(res.SimulatedPreemption):
        repro_torch.biggraphvis(edges, N, cfg, scfg, checkpoint=ck, device="cpu")
    got = repro_torch.biggraphvis(
        edges, N, cfg, scfg,
        checkpoint=res.StreamCheckpointer(str(tmp_path), every_chunks=1, keep=KEEP_ALL),
        resume=True, device="cpu")
    assert got.stream.resumed_at == "detect:r1:c9"
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.positions.tobytes() == want.positions.tobytes()
    assert got.groups.tobytes() == want.groups.tobytes()
    assert got.modularity == want.modularity


def test_post_resume_checkpoints_advance_past_kill_point(tmp_path):
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, on_boundary=res.KillSwitch(10))
    with pytest.raises(res.SimulatedPreemption):
        _run(_edges(), checkpoint=ck)
    stale = res.latest_step(str(tmp_path))
    ck2 = res.StreamCheckpointer(str(tmp_path), every_chunks=8)
    out = _run(_edges(), checkpoint=ck2, resume=True)
    assert out[4].resumed_at and ck2.saves > 0
    assert res.latest_step(str(tmp_path)) > stale
    _, meta = res.restore_latest_valid(str(tmp_path))
    assert meta["step"] > stale
    _check(out)


def test_resume_walks_back_past_metaless_checkpoint(tmp_path):
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, on_boundary=res.KillSwitch(10))
    with pytest.raises(res.SimulatedPreemption):
        _run(_edges(), checkpoint=ck)
    step = res.latest_step(str(tmp_path))
    (tmp_path / f"step_{step:08d}.npz.meta.json").unlink()
    out = _run(_edges(), resume=str(tmp_path))
    assert out[4].resumed_at == "detect:r0:c10"  # the previous boundary's cursor
    _check(out)


def test_resume_fingerprint_mismatch_raises(tmp_path):
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, on_boundary=res.KillSwitch(2))
    with pytest.raises(res.SimulatedPreemption):
        _run(_edges(), checkpoint=ck)
    with pytest.raises(res.CheckpointMismatchError):
        _run(_edges(), checkpoint=res.StreamCheckpointer(str(tmp_path), every_chunks=1),
             resume=True, stream_cfg=StreamConfig(chunk_size=2 * CHUNK))


def test_resume_with_no_checkpoint_starts_fresh(tmp_path):
    out = _run(_edges(), checkpoint=res.StreamCheckpointer(str(tmp_path)), resume=True)
    assert out[4].resumed_at == ""
    assert out[4].stage_seconds["detect_s"] > 0.0
    _check(out)


def test_resume_from_a_directory_path_skips_detect(tmp_path):
    """``resume=<dir>`` without a checkpointer; a supergraph-phase cursor
    skips detect and keeps ``detect_s`` at 0.0."""
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, keep=KEEP_ALL,
                                on_boundary=res.KillSwitch(ROUNDS * N_CHUNKS + 5))
    with pytest.raises(res.SimulatedPreemption):
        _run(_edges(), checkpoint=ck)
    out = _run(_edges(), resume=str(tmp_path))
    stats = out[4]
    assert stats.resumed_at == "supergraph:r0:c6"
    assert stats.stage_seconds["detect_s"] == 0.0 and stats.passes == 1
    assert stats.chunks == N_CHUNKS - 6
    _check(out)


def test_sigterm_checkpoints_then_raises_preempted(tmp_path):
    """The SIGTERM handler in process: the signal lands at a boundary; the
    next boundary saves, then raises ``Preempted``; a resume matches."""
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=0, exit_on_preempt=True)
    old = signal.getsignal(signal.SIGTERM)
    seen = []

    def hook(phase, rnd, chunk):
        seen.append((phase, rnd, chunk))
        if len(seen) == 5:
            os.kill(os.getpid(), signal.SIGTERM)

    ck.on_boundary = hook
    try:
        ck.install_preemption_handler()
        with pytest.raises(res.Preempted, match="detect round 0 chunk 6"):
            _run(_edges(), checkpoint=ck)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ck.saves == 1 and len(seen) == 5
    _, meta = res.restore_latest_valid(str(tmp_path))
    assert (meta["phase"], meta["round"], meta["chunk"]) == ("detect", 0, 6)
    out = _run(_edges(), checkpoint=res.StreamCheckpointer(str(tmp_path)), resume=True)
    _check(out)


def test_sigterm_during_a_save_is_not_lost(tmp_path):
    """A SIGTERM that lands while a boundary is saving (where a boundary
    spends most of its time) is honoured at the next boundary."""
    ck = res.StreamCheckpointer(str(tmp_path), every_chunks=1, exit_on_preempt=True)
    old = signal.getsignal(signal.SIGTERM)

    def payload():
        if ck.saves == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"x": np.arange(3)}

    try:
        ck.install_preemption_handler()
        ck.boundary("detect", 0, 1, False, payload)  # the signal lands in this save
        with pytest.raises(res.Preempted, match="chunk 2"):
            ck.boundary("detect", 0, 2, False, payload)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert ck.saves == 2


def test_preemption_handler_holds_its_checkpointer_weakly(tmp_path):
    """The installed handler does not keep the checkpointer (and its mesh's
    process group) alive: a group destroyed in the interpreter's teardown
    could abort a rank after a clean run. Once the checkpointer is gone a
    SIGTERM does nothing."""
    import gc
    import weakref

    ck = res.StreamCheckpointer(str(tmp_path))
    old = signal.getsignal(signal.SIGTERM)
    try:
        ck.install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert ck.want_save(False)  # the flag is set
        gone = weakref.ref(ck)
        del ck
        gc.collect()
        assert gone() is None
        os.kill(os.getpid(), signal.SIGTERM)  # no checkpointer: nothing to flag
    finally:
        signal.signal(signal.SIGTERM, old)


# ------------------------------------------------ validation & quarantine


def _trash_rows(edges, rows):
    out = edges.copy()
    out[rows] = N
    return out


def _chaos_run(cfg, policy, edges=None):
    store = res.ChaosEdgeStore(_edges() if edges is None else edges, cfg)
    out = _run(store, stream_cfg=StreamConfig(chunk_size=CHUNK, validation=policy))
    return store, out


def test_transient_io_error_retried_to_identical_result():
    offsets = (5 * CHUNK, 17 * CHUNK)
    store, out = _chaos_run(
        res.ChaosConfig(io_error_offsets=offsets, transient_attempts=1),
        res.ValidationPolicy(max_retries=2, retry_backoff_s=0.001))
    stats = out[4]
    assert {k for k, v in store.injected.items()} == {("io", o) for o in offsets}
    assert stats.retries == sum(store.injected.values()) == 2
    assert stats.quarantined_chunks == 0 and stats.dropped_edges == 0
    _check(out)


def test_permanent_io_error_quarantines_and_completes():
    before = REGISTRY.counter("errors.quarantined_chunks").value
    store, out = _chaos_run(res.ChaosConfig(io_error_offsets=(3 * CHUNK,)),
                            res.ValidationPolicy(max_retries=1, retry_backoff_s=0.001))
    stats = out[4]
    assert stats.quarantined_chunks == 1 and stats.quarantined_chunk_ids == [3]
    # every pass hits the chunk and retries it once
    assert store.injected[("io", 3 * CHUNK)] == 2 * (ROUNDS + 1)
    assert stats.retries == ROUNDS + 1
    assert REGISTRY.counter("errors.quarantined_chunks").value - before == ROUNDS + 1
    equiv = _trash_rows(_edges(), slice(3 * CHUNK, 4 * CHUNK))
    _check(out, equiv)


def test_quarantine_disabled_propagates_io_error():
    with pytest.raises(OSError, match="injected I/O error"):
        _chaos_run(res.ChaosConfig(io_error_offsets=(0,)),
                   res.ValidationPolicy(max_retries=1, retry_backoff_s=0.001, quarantine=False))


def test_truncated_read_is_io_error_with_byte_offset():
    cfg = res.ChaosConfig(truncate_offsets=(2 * CHUNK,), truncate_rows=10)
    with pytest.raises(OSError, match="short read") as ei:
        _chaos_run(cfg, res.ValidationPolicy(max_retries=0, quarantine=False))
    assert f"byte offset {(2 * CHUNK + 10) * 8}" in str(ei.value)
    # With quarantine on, the truncated chunk is trash-filled.
    _, out = _chaos_run(cfg, res.ValidationPolicy(max_retries=0))
    assert out[4].quarantined_chunk_ids == [2] and out[4].retries == 0
    _check(out, _trash_rows(_edges(), slice(2 * CHUNK, 3 * CHUNK)))


def test_bitflip_out_of_range_id_dropped_or_raised():
    cfg = res.ChaosConfig(bitflip_offsets=(CHUNK,), seed=3)
    store, out = _chaos_run(cfg, res.ValidationPolicy(retry_backoff_s=0.001))
    row, _ = store.flip_position(CHUNK, CHUNK)
    assert out[4].dropped_edges == ROUNDS + 1  # the flip recurs on every pass
    assert store.injected[("flip", CHUNK)] == ROUNDS + 1
    _check(out, _trash_rows(_edges(), CHUNK + row))
    with pytest.raises(res.ValidationError, match="invalid rows"):
        _chaos_run(cfg, res.ValidationPolicy(on_invalid="error"))


def test_self_loop_policy():
    edges = _edges()
    edges[::100, 1] = edges[::100, 0]  # plant self-loops
    loops = edges[:, 0] == edges[:, 1]
    _, _, _, _, kept = _run(edges.copy(), stream_cfg=StreamConfig(
        chunk_size=CHUNK, validation=res.ValidationPolicy()))
    assert kept.dropped_edges == 0
    out = _run(edges.copy(), stream_cfg=StreamConfig(
        chunk_size=CHUNK, validation=res.ValidationPolicy(self_loops="drop")))
    assert out[4].dropped_edges == int(loops.sum()) * (ROUNDS + 1)
    _check(out, _trash_rows(edges, loops))
    with pytest.raises(res.ValidationError, match="self-loop"):
        _run(edges.copy(), stream_cfg=StreamConfig(
            chunk_size=CHUNK, validation=res.ValidationPolicy(self_loops="error")))


def test_validated_read_leaves_the_callers_array_alone(tmp_path):
    """The policy path reads into staging buffers: an in-memory source is
    never written, and a ``.npy`` source gives the same result."""
    edges = _edges()
    edges[7] = (N + 5, 3)  # out of range: dropped to trash in the buffer only
    before = edges.copy()
    pol = StreamConfig(chunk_size=CHUNK, validation=res.ValidationPolicy())
    out = _run(edges, stream_cfg=pol)
    np.testing.assert_array_equal(edges, before)
    assert out[4].dropped_edges == ROUNDS + 1
    _check(out, _trash_rows(before, 7))
    disk = _run(write_npy(tmp_path / "e.npy", edges), stream_cfg=pol)
    _check(disk, _trash_rows(before, 7))


def test_validation_converts_from_a_reference_config():
    jpol = jres.ValidationPolicy(self_loops="drop", max_retries=4)
    scfg = config_from_reference(JaxStreamConfig(chunk_size=CHUNK, validation=jpol))
    assert isinstance(scfg.validation, res.ValidationPolicy)
    assert repr(scfg.validation) == repr(jpol)


def test_error_counters_registered_at_zero():
    reg = MetricsRegistry()
    ensure_error_counters(reg)
    txt = reg.dump_text(prefix="errors.")
    for name in ERROR_COUNTERS:
        assert f"{name} 0" in txt
    reg.counter("errors.io_retries").inc(3)
    ensure_error_counters(reg)
    assert reg.counter("errors.io_retries").value == 3
    # A clean validated read leaves every counter at 0 in its registry.
    fresh = MetricsRegistry()
    buf = np.empty((CHUNK, 2), np.int32)
    res.validated_read(res.ChaosEdgeStore(_edges(), res.ChaosConfig()), 0, CHUNK, buf, N,
                       res.ValidationPolicy(), res.ValidationAccounting(), registry=fresh)
    assert {fresh.counter(n).value for n in ERROR_COUNTERS} == {0}
    assert "errors.io_retries 0" in fresh.dump_text(prefix="errors.")


# -------------------------------------------------- FA2 divergence sentinel


def test_poison_weights_matches_reference():
    w = np.abs(np.random.default_rng(3).normal(1.0, 0.2, 120)).astype(np.float32)
    got, want = res.poison_weights(w, k=4, seed=1), jres.poison_weights(w, k=4, seed=1)
    assert got.tobytes() == want.tobytes() and np.isnan(got).sum() == 4
    assert res.poison_weights(w, k=0).tobytes() == w.tobytes()


def test_nan_guard_recovers_from_poisoned_forces():
    rng = np.random.default_rng(3)
    n = 40
    e = rng.integers(0, n, (120, 2), dtype=np.int32)
    w = res.poison_weights(np.abs(rng.normal(1.0, 0.2, 120)).astype(np.float32), k=4, seed=1)
    mass = np.ones(n, np.float32)
    pos0 = rng.uniform(-1000.0, 1000.0, (n, 2)).astype(np.float32)
    for guard in (False, True):
        cfg = jfa2.FA2Config(iterations=20, nan_guard=guard)
        jpos, jtr, jits = jfa2.layout(e, w, mass, n, cfg, pos0=pos0)
        pos, tr, its = fa2.layout(e, w, mass, n, config_from_reference(cfg),
                                  pos0=torch.as_tensor(pos0), device="cpu")
        assert np.isfinite(pos.numpy()).all() == guard
        assert np.isfinite(np.asarray(jpos)).all() == guard
        assert fa2.recovery_count(tr) == jfa2.recovery_count(jtr)
        assert int(its) == int(jits) == 20
    assert fa2.recovery_count(tr) > 0
    # tol ≤ 1: a recovery row never reads as converged.
    cfg = fa2.FA2Config(iterations=20, nan_guard=True, stop_tolerance=0.5, min_iterations=1)
    _, tr, its = fa2.layout(e, w, mass, n, cfg, pos0=torch.as_tensor(pos0), device="cpu")
    assert int(its) == 20 and fa2.recovery_count(tr) == 20


# ----------------------------------------------- step-counted fault tolerance


def test_checkpoint_manager_and_elastic_plan(tmp_path):
    mgr = res.CheckpointManager(str(tmp_path), every_steps=2, keep=2)
    assert not mgr.should_save(0) and mgr.should_save(2) and not mgr.should_save(3)
    like = {"w": torch.zeros(3), "step": torch.zeros((), dtype=torch.int64)}
    for step in (2, 4):
        mgr.save(step, {"w": torch.full((3,), float(step)), "step": torch.tensor(step)})
    (tmp_path / "step_00000004.npz").write_bytes(b"rot")
    step, tree, meta = mgr.restore_latest(like)
    assert step == 2 and meta["step"] == 2 and torch.equal(tree["w"], torch.full((3,), 2.0))
    assert res.ElasticPlan(8, 4).data_shard_for(3, 0) == (6, 2)
    with pytest.raises(ValueError, match="divide"):
        res.ElasticPlan(8, 3).batch_per_pod()
    assert json.loads((tmp_path / "step_00000002.npz.meta.json").read_text())["step"] == 2
    assert jres.ElasticPlan(8, 4).data_shard_for(3, 0) == (6, 2)
