"""Streaming chunked-edge execution engine (paper §3: community information
extracted "in a few passes on the edge list").

The engine keeps the edge list out of device memory and drives every
edge-consuming stage over fixed-size chunks:

    EdgeStore (host array · mmap .npy/.bin · sharded files)
        ──► EdgeChunkStream (padded chunk buffers)
        ──► pinned host staging ring + non-blocking host→device copies
        ──► per-chunk update steps (SCoDA labels+degrees · graph degrees ·
            superedge aggregation · modularity accumulators · CMS sketch)
        ──► finalize: Supergraph + labels, device-resident node-sized state

Device residency is O(n_nodes + chunk_size + max_super_edges + sketch) —
independent of |E| — and with a disk-backed ``EdgeStore`` host residency is
too: the only host buffers are the staging ring.

The staging ring (CUDA only) is a set of pinned buffers. A chunk is read
into a slot, copied to the device with ``non_blocking=True`` on the current
stream, and handed to the consumer; when the consumer asks for the next
chunk, a CUDA event is recorded on that stream — after the copy *and* the
work that consumed it. A slot is refilled only once its event has
completed, so a staged buffer is never overwritten while a queued copy may
still read it. On the CPU, chunks are zero-copy views of the source.

Node ids outside ``[0, n_nodes]`` are routed to the trash node as a chunk
enters the device (``graph.utils.sanitize_edges``): such edges are dropped.
With ``StreamConfig.validation`` (a ``resilience.ValidationPolicy``) every
chunk is read defensively instead (``resilience.validate``): transient
I/O errors retry, unreadable chunks are quarantined, invalid rows drop to
the trash node whole, and each is counted in ``StreamStats``.

Checkpoint/resume (``stream_pipeline(checkpoint=, resume=)``): at every
chunk boundary a ``resilience.StreamCheckpointer`` receives the resume
cursor and a lazy payload of the stage's state, which it takes to the host
only at a boundary that saves; a resumed run replays no chunk and skips
none, so it is bit-identical to an uninterrupted one. The checkpoints are
the reference package's format.

Bit-exactness: every stage's one-shot function feeds the same chunk-update
body, and the SCoDA block partition is preserved because chunk sizes are
rounded up to a multiple of ``ScodaConfig.block_size`` — so chunked and
one-shot runs produce identical labels, supergraphs and modularity sums
whatever the source.

Not in this slice (each raises ``NotImplementedError``): multi-device
meshes (``mesh``, ``shard_detect``, ``shard_layout``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import cms as cms_lib
from repro_torch.core.modularity import (
    modularity_finalize,
    modularity_init,
    modularity_update,
)
from repro_torch.core.scoda import (
    ScodaConfig,
    dense_labels,
    round_threshold,
    scoda_finalize,
    scoda_init,
    scoda_update,
)
from repro_torch.core.supergraph import (
    Supergraph,
    agg_finalize,
    agg_init,
    agg_update,
    community_sizes,
)
from repro_torch.data.edge_store import EDGE_DTYPE, InMemoryEdgeStore, as_edge_store
from repro_torch.device import resolve_device, synchronize
from repro_torch.graph.utils import sanitize_edges
from repro_torch.obs.metrics import REGISTRY, ensure_error_counters
from repro_torch.obs.trace import get_tracer
from repro_torch.resilience.checkpoint import (
    CheckpointMismatchError,
    config_fingerprint,
    restore_latest_valid,
)
from repro_torch.resilience.validate import ValidationAccounting, validated_read

_ROADMAP_MESH = "ROADMAP.md, modules to port, item 14 (multi-device paths)"


def not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"repro_torch does not port {what} yet: {item}")


@dataclass(frozen=True)
class StreamConfig:
    """Engine knobs. ``chunk_size`` is rounded up to a multiple of the SCoDA
    block size so the chunked block partition matches the one-shot one.
    ``prefetch`` sets the staging ring to ``max(2, prefetch + 1)`` slots.
    ``agg_backend`` selects the superedge aggregation ("merge" or
    "lexsort"; bit-identical below capacity). ``obs`` is an explicit
    ``Tracer`` (None = the process-global one). ``validation`` (a
    ``resilience.ValidationPolicy``) makes every chunk read defensive (see
    the module docstring; None = trusting).

    ``mesh``, ``shard_detect`` and ``shard_layout`` exist so a reference
    config converts field for field; setting any of them raises
    ``NotImplementedError`` when the engine runs."""

    chunk_size: int = 1 << 16  # edges resident on device per chunk
    prefetch: int = 1
    agg_backend: str = "merge"  # superedge aggregation: "merge" | "lexsort"
    mesh: object = None
    shard_detect: bool = False
    shard_layout: bool = False
    obs: object = None
    validation: object = None

    def check_slice(self) -> None:
        if self.mesh is not None or self.shard_detect or self.shard_layout:
            raise not_in_slice("multi-device streaming (mesh/shard_*)", _ROADMAP_MESH)


@dataclass
class StreamStats:
    """Per-run accounting. ``peak_device_bytes`` is the analytic resident
    footprint of the streaming state (chunk buffers + node/sketch/agg
    state); ``peak_host_bytes`` its host-side mirror. ``host_fill_s`` is
    time spent reading the store into staging; ``copy_stall_s`` is time
    blocked waiting for a staging slot's event — both ≈ 0 when copies
    overlap compute.

    Resilience accounting, copied from the stream's
    ``ValidationAccounting``: ``quarantined_*`` report *distinct* chunks (a
    permanently bad chunk is hit once per pass; the per-occurrence tally is
    the ``errors.quarantined_chunks`` counter). ``resumed_at`` is the
    checkpoint cursor a resumed run picked up from ("" for an
    uninterrupted run)."""

    passes: int = 0
    chunks: int = 0
    edges_streamed: int = 0
    seconds: float = 0.0
    chunk_size: int = 0
    peak_device_bytes: int = 0
    peak_host_bytes: int = 0
    host_fill_s: float = 0.0
    copy_stall_s: float = 0.0
    stage_seconds: dict = field(default_factory=dict)
    retries: int = 0
    quarantined_chunks: int = 0
    quarantined_chunk_ids: list = field(default_factory=list)
    dropped_edges: int = 0
    resumed_at: str = ""

    @property
    def edges_per_s(self) -> float:
        return self.edges_streamed / self.seconds if self.seconds > 0 else 0.0

    def publish(self, registry=None) -> None:
        """Mirror this run's accounting into the metrics registry
        (``repro_torch.obs.metrics.REGISTRY`` by default): counters
        accumulate across runs, per-run seconds land as gauges, residency
        peaks as high-watermark gauges."""
        reg = registry if registry is not None else REGISTRY
        ensure_error_counters(reg)
        reg.counter("stream.runs").inc()
        reg.counter("stream.passes").inc(self.passes)
        reg.counter("stream.chunks").inc(self.chunks)
        reg.counter("stream.edges").inc(self.edges_streamed)
        for name, value in (
            ("stream.seconds", self.seconds),
            ("stream.edges_per_s", self.edges_per_s),
            ("stream.chunk_size", self.chunk_size),
            ("stream.host_fill_s", self.host_fill_s),
            ("stream.copy_stall_s", self.copy_stall_s),
        ):
            reg.gauge(name).set(value)
        for stage, secs in self.stage_seconds.items():
            reg.gauge(f"stream.stage.{stage}").set(secs)
        reg.gauge("stream.peak_device_bytes").set_max(self.peak_device_bytes)
        reg.gauge("stream.peak_host_bytes").set_max(self.peak_host_bytes)


def tree_bytes(*trees) -> int:
    """Total bytes of every tensor in the given (nested) tuples; None
    entries count 0."""
    total = 0
    for tree in trees:
        if isinstance(tree, tuple):
            total += tree_bytes(*tree)
        elif tree is not None:
            total += tree.numel() * tree.element_size()
    return total


class EdgeChunkStream:
    """Chunked view over any edge source (``repro_torch.data.edge_store``).

    Yields [chunk_size, 2] int32 chunks; the tail chunk is padded with the
    trash node ``n_nodes`` (a no-op for every chunk-update body). The source
    is validated (dtype/shape) once, at construction. ``device_chunks`` is
    one pass, as described in the module docstring.

    With a ``policy`` (``resilience.ValidationPolicy``) every chunk, of an
    in-memory source too, goes through ``validated_read`` into a staging
    buffer — a fresh array on the CPU, the pinned ring slot on CUDA — never
    a view of the caller's edge array, since the read writes trash into
    it. ``acct`` holds the run's retries, quarantined chunks and dropped
    rows.
    """

    def __init__(self, source, n_nodes: int, chunk_size: int,
                 block_size: int = 1, policy=None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.store = as_edge_store(source)
        self.n_nodes = n_nodes
        self.n_edges = self.store.n_edges
        self.policy = policy
        self.acct = ValidationAccounting()
        # Round up so chunk boundaries align with SCoDA block boundaries,
        # and clamp to the padded edge list.
        bs = max(1, block_size)
        cap = max(bs, ((self.n_edges + bs - 1) // bs) * bs)
        self.chunk_size = min(((chunk_size + bs - 1) // bs) * bs, cap)
        self.n_chunks = max(1, -(-self.n_edges // self.chunk_size))
        self.passes = 0
        self.edges = (
            self.store.array
            if isinstance(self.store, InMemoryEdgeStore) and policy is None
            else None
        )
        self._ring = None  # pinned staging slots (CUDA path), built lazily
        self._events = None  # per-slot event recorded after the slot's consumer
        if self.edges is not None:
            # The tail chunk is identical every pass: pad it once.
            start = (self.n_chunks - 1) * self.chunk_size
            self._tail_buf = np.full((self.chunk_size, 2), n_nodes, dtype=EDGE_DTYPE)
            self._tail_buf[: self.n_edges - start] = self.edges[start:]
        else:
            self._tail_buf = None

    @property
    def chunk_bytes(self) -> int:
        return self.chunk_size * 2 * 4

    def staging_buffers(self, prefetch: int = 1) -> int:
        """Pinned slots of the CUDA staging ring."""
        return max(2, prefetch + 1)

    def inflight_buffers(self, prefetch: int = 1) -> int:
        """Device-side chunk buffers alive at once."""
        return min(self.n_chunks, self.staging_buffers(prefetch))

    def host_bytes(self, prefetch: int = 1) -> int:
        """Host residency: the store's own bytes, the in-memory tail buffer,
        and the staging ring."""
        tail = self._tail_buf.nbytes if self._tail_buf is not None else 0
        return (
            self.store.resident_bytes + tail
            + self.staging_buffers(prefetch) * self.chunk_bytes
        )

    def _read_chunk(self, i: int, buf: np.ndarray) -> np.ndarray:
        if self.policy is not None:
            return validated_read(self.store, i, self.chunk_size, buf,
                                  self.n_nodes, self.policy, self.acct)
        if self.edges is not None and i == self.n_chunks - 1:
            buf[:] = self._tail_buf
            return buf
        k = self.store.read_into(i * self.chunk_size, buf)
        if k < self.chunk_size:
            buf[k:] = self.n_nodes  # pad the tail with the trash node
        return buf

    def _host_chunks(self, start: int = 0):
        """Host chunks from chunk ``start`` on (the resume cursor)."""
        cs = self.chunk_size
        if self.edges is not None:
            for i in range(start, self.n_chunks - 1):
                yield self.edges[i * cs:(i + 1) * cs]
            if start <= self.n_chunks - 1:
                yield self._tail_buf
        else:
            for i in range(start, self.n_chunks):
                yield self._read_chunk(i, np.empty((cs, 2), dtype=EDGE_DTYPE))

    def device_chunks(self, device, prefetch: int = 1,
                      stats: StreamStats | None = None, start: int = 0):
        """One pass of [chunk_size, 2] int32 chunks on ``device``, from
        chunk ``start`` on (the checkpoint/resume cursor)."""
        self.passes += 1
        device = torch.device(device)
        if device.type != "cuda":
            for buf in self._host_chunks(start):
                t = torch.from_numpy(np.ascontiguousarray(buf)).to(device)
                yield sanitize_edges(t, self.n_nodes)
            return
        nbuf = self.staging_buffers(prefetch)
        if self._ring is None or len(self._ring) < nbuf:
            self._ring = [
                torch.empty((self.chunk_size, 2), dtype=torch.int32).pin_memory()
                for _ in range(nbuf)
            ]
            self._events = [None] * nbuf
        stream = torch.cuda.current_stream(device)
        for i in range(start, self.n_chunks):
            slot = i % nbuf
            if self._events[slot] is not None:
                # The ring wrapped: wait until the copy out of this slot and
                # the work that consumed it have completed.
                t0 = time.perf_counter()
                self._events[slot].synchronize()
                if stats is not None:
                    stats.copy_stall_s += time.perf_counter() - t0
                self._events[slot] = None
            t0 = time.perf_counter()
            self._read_chunk(i, self._ring[slot].numpy())
            if stats is not None:
                stats.host_fill_s += time.perf_counter() - t0
            dev = self._ring[slot].to(device, non_blocking=True)
            yield sanitize_edges(dev, self.n_nodes)
            # Resumed: the consumer has queued its work on this chunk.
            event = torch.cuda.Event()
            event.record(stream)
            self._events[slot] = event


def _degree_update(deg, chunk):
    """Chunk-incremental graph degrees ([n+1] int32 accumulator, trash last),
    updated in place."""
    one = torch.ones(chunk.shape[0], dtype=torch.int32, device=chunk.device)
    deg.index_add_(0, chunk[:, 0].long(), one)
    deg.index_add_(0, chunk[:, 1].long(), one)
    deg[-1] = 0
    return deg


def _account_pass_peaks(stats, stream, prefetch, *state_trees):
    state_b = tree_bytes(*state_trees)
    chunk_b = stream.chunk_bytes * stream.inflight_buffers(prefetch)
    stats.peak_device_bytes = max(stats.peak_device_bytes, state_b + chunk_b)
    stats.peak_host_bytes = max(stats.peak_host_bytes, stream.host_bytes(prefetch))


def _restored(resume: dict, key: str, device):
    """A checkpointed host array as a tensor of its own on ``device``."""
    return torch.from_numpy(np.array(resume[key], copy=True)).to(device)


def stream_detect(stream: EdgeChunkStream, n_nodes: int, cfg: ScodaConfig, *,
                  device, prefetch: int = 1, stats: StreamStats | None = None,
                  tracer=None, ckpt=None, resume: dict | None = None):
    """Multi-round SCoDA over the chunk stream; graph degrees are fused into
    the first pass. Returns (labels [n], scoda_deg [n], graph_deg [n]).
    ``tracer`` emits the ``detect``/``detect.round``/``detect.chunk`` span
    tree (None = process-global tracer).

    ``ckpt`` (a ``resilience.StreamCheckpointer``) is notified at every
    chunk boundary with the resume cursor — the (round, chunk) of the next
    unprocessed chunk, ``(r + 1, 0)`` at the end of round r — and a lazy
    payload of the detect state (``com``, ``deg`` and the graph-degree
    accumulator ``gdeg``, each [n+1]). ``resume`` is that payload plus the
    cursor (``{"round", "chunk", "com", "deg", "gdeg"}``, host arrays): the
    loops pick up exactly there."""
    tr = tracer if tracer is not None else get_tracer()
    device = torch.device(device)
    state = scoda_init(n_nodes, device)
    gdeg = torch.zeros(n_nodes + 1, dtype=torch.int32, device=device)
    start_round, start_chunk = 0, 0
    if resume is not None:
        start_round, start_chunk = int(resume["round"]), int(resume["chunk"])
        state = (_restored(resume, "com", device), _restored(resume, "deg", device))
        gdeg = _restored(resume, "gdeg", device)
    with tr.span("detect", rounds=cfg.rounds, chunk_size=stream.chunk_size):
        for r in range(start_round, cfg.rounds):
            thr = round_threshold(cfg, r)
            c0 = start_chunk if r == start_round else 0
            with tr.span("detect.round", round=r):
                for i, chunk in enumerate(
                    stream.device_chunks(device, prefetch, stats, start=c0), start=c0
                ):
                    with tr.span("detect.chunk", round=r, chunk=i):
                        if r == 0:
                            gdeg = _degree_update(gdeg, chunk)
                        state = scoda_update(state, chunk, thr, cfg)
                    if stats is not None:
                        stats.chunks += 1
                        stats.edges_streamed += chunk.shape[0]
                    if ckpt is not None:
                        last = i + 1 == stream.n_chunks
                        nr, nc = (r + 1, 0) if last else (r, i + 1)
                        ckpt.boundary("detect", nr, nc, last,
                                      lambda s=state, g=gdeg: {
                                          "com": s[0], "deg": s[1], "gdeg": g})
    if stats is not None:
        stats.passes += cfg.rounds - start_round
        _account_pass_peaks(stats, stream, prefetch, state, gdeg)
    labels, scoda_deg = scoda_finalize(state, n_nodes, cfg)
    return labels, scoda_deg, gdeg[:n_nodes]


def stream_supergraph(stream: EdgeChunkStream, labels, node_deg, n_nodes: int,
                      s_cap: int, max_super_edges: int,
                      cms_cfg: cms_lib.CMSConfig, *, device, prefetch: int = 1,
                      stats: StreamStats | None = None,
                      with_modularity: bool = True, agg_backend: str = "merge",
                      tracer=None, ckpt=None, resume: dict | None = None):
    """One fused pass: superedge aggregation + modularity accumulation.

    CMS community sizing is node-keyed (one sketch update per node, weight =
    graph degree) and so needs no edge pass. Returns (Supergraph, Q) with Q
    None when ``with_modularity`` is false.

    ``ckpt``/``resume`` follow ``stream_detect``'s contract (cursor
    ``(0, i + 1)``). The payload carries the aggregation and modularity
    accumulators *and* the detect outputs (``labels``, graph degrees as
    ``deg``), so a run killed in this pass resumes without re-running
    detect; dense labels and the CMS sizes are recomputed from the labels.
    """
    tr = tracer if tracer is not None else get_tracer()
    device = torch.device(device)
    with tr.span("supergraph", chunk_size=stream.chunk_size, s_cap=s_cap,
                 agg_backend=agg_backend):
        labels_dense, n_supernodes = dense_labels(labels, n_nodes)
        with tr.span("supergraph.sizes"):
            sizes = community_sizes(
                labels_dense, node_deg, n_supernodes, s_cap, cms_cfg
            )
        agg_ext = torch.cat(
            [labels_dense, torch.full((1,), s_cap, dtype=torch.int32, device=device)]
        )
        mod_ext = torch.cat(
            [labels_dense, torch.full((1,), -1, dtype=torch.int32, device=device)]
        )
        agg = agg_init(s_cap, max_super_edges, device)
        mod = modularity_init(n_nodes, device) if with_modularity else None
        start_chunk = 0
        if resume is not None:
            start_chunk = int(resume["chunk"])
            agg = tuple(_restored(resume, k, device)
                        for k in ("agg_a", "agg_b", "agg_w", "agg_n"))
            if with_modularity:
                mod = tuple(_restored(resume, k, device)
                            for k in ("mod_m", "mod_intra", "mod_dcom"))

        def payload(a, md):
            out = {"labels": labels, "deg": node_deg, "agg_a": a[0], "agg_b": a[1],
                   "agg_w": a[2], "agg_n": a[3]}
            if md is not None:
                out.update(mod_m=md[0], mod_intra=md[1], mod_dcom=md[2])
            return out

        for i, chunk in enumerate(
            stream.device_chunks(device, prefetch, stats, start=start_chunk),
            start=start_chunk,
        ):
            with tr.span("supergraph.chunk", chunk=i):
                agg = agg_update(agg, chunk, agg_ext, s_cap, max_super_edges,
                                 agg_backend)
                if with_modularity:
                    mod = modularity_update(mod, chunk, mod_ext)
            if stats is not None:
                stats.chunks += 1
                stats.edges_streamed += chunk.shape[0]
            if ckpt is not None:
                ckpt.boundary("supergraph", 0, i + 1, i + 1 == stream.n_chunks,
                              lambda a=agg, md=mod: payload(a, md))
    if stats is not None:
        stats.passes += 1
        _account_pass_peaks(
            stats, stream, prefetch, agg, mod, labels_dense, sizes, node_deg
        )
    sedges, sweights, n_superedges = agg_finalize(agg)
    q = modularity_finalize(mod) if with_modularity else None
    sg = Supergraph(
        edges=sedges,
        weights=sweights,
        sizes=sizes,
        n_supernodes=n_supernodes,
        n_superedges=n_superedges,
        labels=labels_dense,
    )
    return sg, q


def _find_resume(resume, checkpoint, fingerprint: str):
    """The newest checkpoint to resume from as ``(arrays, meta)``, or None.

    ``resume`` is True (the checkpointer's directory) or a directory path.
    A checkpoint without the resume cursor (its meta lost to a crash) is
    walked back past; a fingerprint that differs from this run's raises."""
    if isinstance(resume, (str, os.PathLike)):
        ckpt_dir = os.fspath(resume)
    else:
        ckpt_dir = checkpoint.ckpt_dir if checkpoint is not None else None
    if not ckpt_dir:
        return None
    found = restore_latest_valid(ckpt_dir, valid=lambda a, m: "chunk" in m)
    if found is not None:
        meta = found[1]
        if meta.get("fingerprint") and meta["fingerprint"] != fingerprint:
            raise CheckpointMismatchError(
                f"checkpoint {ckpt_dir} was written by a run with fingerprint "
                f"{meta['fingerprint']}, this run is {fingerprint} — resuming "
                "would not be bit-identical"
            )
    return found


def stream_pipeline(source, n_nodes: int, scoda_cfg: ScodaConfig,
                    cms_cfg: cms_lib.CMSConfig, s_cap: int, max_super_edges: int,
                    stream_cfg: StreamConfig | None = None, *,
                    with_modularity: bool = True, tracer=None, checkpoint=None,
                    resume=False, device=None):
    """Edge source → (labels, graph degrees, Supergraph, Q, StreamStats).

    ``source`` is anything ``as_edge_store`` accepts: a host NumPy array, an
    ``EdgeStore``, a path to a ``.npy``/``.bin`` edge file or shard
    directory, or a list of shard paths. ``device=None`` means CUDA.

    ``checkpoint`` is a ``resilience.StreamCheckpointer``: the run then
    persists its streaming state at the checkpointer's cadence, stamped
    with this config's fingerprint (the reference's, so the packages
    resume each other's checkpoints). ``resume`` is False, True (the
    newest valid checkpoint under ``checkpoint.ckpt_dir``) or a directory
    path; a fingerprint mismatch raises ``CheckpointMismatchError``, and a
    resume with no checkpoint on disk starts fresh. A resumed run is
    bit-identical to an uninterrupted one.
    """
    device = resolve_device(device)
    store = as_edge_store(source)
    cfg = stream_cfg or StreamConfig(chunk_size=max(1, store.n_edges))
    cfg.check_slice()
    tr = tracer if tracer is not None else (
        cfg.obs if cfg.obs is not None else get_tracer()
    )
    stream = EdgeChunkStream(store, n_nodes, cfg.chunk_size,
                             block_size=scoda_cfg.block_size, policy=cfg.validation)
    stats = StreamStats(chunk_size=stream.chunk_size)
    fingerprint = config_fingerprint(
        n_nodes=n_nodes, n_edges=store.n_edges, chunk_size=stream.chunk_size,
        scoda=scoda_cfg, cms=cms_cfg, s_cap=s_cap,
        max_super_edges=max_super_edges, agg_backend=cfg.agg_backend,
        with_modularity=with_modularity,
    )
    if checkpoint is not None:
        checkpoint.fingerprint = fingerprint
    resume_detect = resume_sg = None
    labels = gdeg = None
    found = _find_resume(resume, checkpoint, fingerprint) if resume else None
    if found is not None:
        arrays, meta = found
        if checkpoint is not None:
            checkpoint.seed(meta)
        phase = meta.get("phase", "detect")
        cursor = {"round": meta.get("round", 0), "chunk": meta["chunk"]}
        if phase == "detect":
            resume_detect = {**cursor, **arrays}
        else:
            resume_sg = {**cursor, **arrays}
            labels = _restored(arrays, "labels", device)
            gdeg = _restored(arrays, "deg", device)
        stats.resumed_at = f"{phase}:r{cursor['round']}:c{cursor['chunk']}"

    with tr.span("stream_pipeline", n_nodes=n_nodes, n_edges=store.n_edges,
                 chunk_size=stream.chunk_size):
        # Resuming past detect skips the stage; the timing key stays.
        stats.stage_seconds["detect_s"] = 0.0
        if resume_sg is None:
            t0 = time.perf_counter()
            labels, _scoda_deg, gdeg = stream_detect(
                stream, n_nodes, scoda_cfg, device=device, prefetch=cfg.prefetch,
                stats=stats, tracer=tr, ckpt=checkpoint, resume=resume_detect,
            )
            synchronize(device)
            stats.stage_seconds["detect_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sg, q = stream_supergraph(
            stream, labels, gdeg, n_nodes, s_cap, max_super_edges, cms_cfg,
            device=device, prefetch=cfg.prefetch, stats=stats,
            with_modularity=with_modularity, agg_backend=cfg.agg_backend,
            tracer=tr, ckpt=checkpoint, resume=resume_sg,
        )
        synchronize(device)
        stats.stage_seconds["supergraph_s"] = time.perf_counter() - t0
    stats.seconds = sum(stats.stage_seconds.values())
    stats.retries = stream.acct.retries
    qids = sorted(set(stream.acct.quarantined))  # a bad chunk recurs every pass
    stats.quarantined_chunks = len(qids)
    stats.quarantined_chunk_ids = qids
    stats.dropped_edges = stream.acct.dropped_edges
    stats.publish()
    return labels, gdeg, sg, q, stats


def oneshot_device_bytes(n_edges: int, n_nodes: int) -> int:
    """Resident bytes the one-shot path pins just to hold the inputs: the
    full padded edge list + node-sized state. The streaming engine's
    ``peak_device_bytes`` replaces the |E| term with the chunk buffers."""
    return n_edges * 2 * 4 + 2 * (n_nodes + 1) * 4
