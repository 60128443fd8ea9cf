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

Multi-device (``StreamConfig.mesh``, a ``launch.mesh.StreamMesh``): one
process per rank, each calling the same entry point. With ``shard_detect``
each rank reads only its own rows of every chunk from the source into its
staging slot — the same within-block slice of every SCoDA block in the
detect pass (``sharding.block_chunk_spec``), contiguous C/D rows in the
supergraph pass (``row_chunk_spec``) — and the updates merge across ranks
so that every rank ends with the single-rank result, bitwise:

* SCoDA: one all-gather of each block's slices (b×2 int32), then the
  single-rank block update, replicated (``core/scoda.py``);
* graph degrees: local counts, one all-reduce of [n+1] int32 per chunk of
  the first round;
* aggregation: local dedupe, one all-gather of the deduped runs per chunk,
  a second dedupe, K1 (``core/supergraph.py``);
* modularity: local sums, one all-reduce of [2n+3] float32 per chunk;
* CMS sizing: each rank sketches its slice of the node keys, one
  all-reduce of the sketch (``core/cms.py``).

Both passes fall back to one rank (``StreamStats.devices == 1``) unless
the block size and the chunk size divide by the rank count. A checkpointer
with a mesh writes from rank 0 only, the others waiting at a barrier, and
agrees a SIGTERM seen by any rank before acting on it; with a validation
policy every rank reads the whole chunk (the same reads, faults and
verdicts as one rank would see) and a quarantine seen by any rank is taken
by all.
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
    sharded_modularity_update,
)
from repro_torch.core.scoda import (
    ScodaConfig,
    dense_labels,
    round_threshold,
    scoda_finalize,
    scoda_init,
    scoda_update,
    sharded_scoda_update,
)
from repro_torch.core.supergraph import (
    Supergraph,
    agg_finalize,
    agg_init,
    agg_update,
    community_sizes,
    sharded_agg_update,
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
from repro_torch.sharding import (
    all_reduce,
    any_rank,
    barrier,
    block_chunk_spec,
    row_chunk_spec,
)


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

    ``mesh`` (a ``launch.mesh.StreamMesh``, None = one rank) with
    ``shard_detect`` spreads every per-chunk edge pass over the ranks (see
    the module docstring); ``shard_layout`` asks the supergraph layout
    (``core/pipeline.py``) to node-partition its force pass over the same
    mesh (``fa2.layout_sharded``). A reference config's mesh does not
    convert (``convert.config_from_reference`` maps it to None)."""

    chunk_size: int = 1 << 16  # edges resident on device per chunk
    prefetch: int = 1
    agg_backend: str = "merge"  # superedge aggregation: "merge" | "lexsort"
    mesh: object = None  # launch.mesh.StreamMesh (None = one rank)
    shard_detect: bool = False  # spread the per-chunk edge passes over mesh
    shard_layout: bool = False  # node-partition the FA2 layout over mesh
    obs: object = None
    validation: object = None


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
    uninterrupted run).

    ``devices`` is the rank count the sharded passes actually ran on (1 =
    unsharded, a fallback included); ``peak_local_bytes`` the analytic
    per-rank footprint: replicated state at full size plus this rank's 1/D
    of the chunk buffers (``peak_device_bytes`` when ``devices`` is 1)."""

    passes: int = 0
    chunks: int = 0
    edges_streamed: int = 0
    seconds: float = 0.0
    chunk_size: int = 0
    devices: int = 1
    peak_device_bytes: int = 0
    peak_local_bytes: int = 0
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
            ("stream.devices", self.devices),
            ("stream.host_fill_s", self.host_fill_s),
            ("stream.copy_stall_s", self.copy_stall_s),
        ):
            reg.gauge(name).set(value)
        for stage, secs in self.stage_seconds.items():
            reg.gauge(f"stream.stage.{stage}").set(secs)
        reg.gauge("stream.peak_device_bytes").set_max(self.peak_device_bytes)
        reg.gauge("stream.peak_local_bytes").set_max(self.peak_local_bytes)
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
    rows. With a ``mesh`` (several ranks) the ranks agree every quarantine
    verdict before they act on it.
    """

    def __init__(self, source, n_nodes: int, chunk_size: int,
                 block_size: int = 1, policy=None, mesh=None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        self.store = as_edge_store(source)
        self.n_nodes = n_nodes
        self.n_edges = self.store.n_edges
        self.policy = policy
        self.mesh = mesh
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
            before = len(self.acct.quarantined)
            validated_read(self.store, i, self.chunk_size, buf, self.n_nodes,
                           self.policy, self.acct)
            if self.mesh is not None:
                # Every rank read the whole chunk; a quarantine on any rank
                # is taken by all, so no two ranks stream different edges.
                mine = len(self.acct.quarantined) > before
                if any_rank(mine, self.mesh) and not mine:
                    buf[:] = self.n_nodes
                    self.acct.quarantined.append(i)
                    REGISTRY.counter("errors.quarantined_chunks").inc()
            return buf
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

    def _read_local(self, i: int, buf: np.ndarray, spec) -> np.ndarray:
        """This rank's rows of chunk ``i`` (``spec``) into ``buf``. Trusting
        reads fetch only those rows from the store; with a policy the whole
        chunk is read defensively (``_read_chunk``) and the rows kept."""
        c = self.chunk_size
        if self.policy is not None:
            buf[:] = spec.take(self._read_chunk(i, np.empty((c, 2), dtype=EDGE_DTYPE)))
            return buf
        off = 0
        for a, b in spec.runs(c):
            seg = buf[off:off + b - a]
            k = self.store.read_into(i * c + a, seg)
            seg[k:] = self.n_nodes  # past the end: trash
            off += b - a
        return buf

    def device_chunks(self, device, prefetch: int = 1,
                      stats: StreamStats | None = None, start: int = 0,
                      spec=None, put=None):
        """One pass of int32 chunks on ``device``, from chunk ``start`` on
        (the checkpoint/resume cursor).

        Each is [chunk_size, 2], or with a ``spec`` (``sharding.ChunkSpec``)
        this rank's [chunk_size / D, 2] rows of it. ``put`` (a host chunk →
        device tensor) replaces the engine's own host→device copy of whole
        chunks (``launch.stream_runner.StreamRunner.put``)."""
        self.passes += 1
        device = torch.device(device)
        rows = self.chunk_size if spec is None else spec.local_rows(self.chunk_size)

        def fill(i, buf):
            return self._read_chunk(i, buf) if spec is None else self._read_local(i, buf, spec)

        if device.type != "cuda":
            if spec is None:
                chunks = self._host_chunks(start)
            else:
                chunks = (fill(i, np.empty((rows, 2), dtype=EDGE_DTYPE))
                          for i in range(start, self.n_chunks))
            for buf in chunks:
                t = put(buf) if put is not None else \
                    torch.from_numpy(np.ascontiguousarray(buf)).to(device)
                yield sanitize_edges(t, self.n_nodes)
            return
        nbuf = self.staging_buffers(prefetch)
        if self._ring is None or len(self._ring) < nbuf or self._ring[0].shape[0] != rows:
            for ev in self._events or ():
                if ev is not None:
                    ev.synchronize()  # a slot of the old ring may still be read
            self._ring = [
                torch.empty((rows, 2), dtype=torch.int32).pin_memory()
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
            fill(i, self._ring[slot].numpy())
            if stats is not None:
                stats.host_fill_s += time.perf_counter() - t0
            if put is not None:
                dev = put(self._ring[slot].numpy())
            else:
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


def _sharded_degree_update(deg, local, mesh):
    """``_degree_update`` of a chunk whose rows are spread over ``mesh``
    (``local``: this rank's rows): local counts, one integer all-reduce."""
    inc = all_reduce(_degree_update(torch.zeros_like(deg), local), mesh, "sum")
    deg += inc
    deg[-1] = 0
    return deg


def _effective_mesh(mesh, shard: bool, *divisible: int):
    """The mesh to shard on, or None: sharding must be asked for, the mesh
    must hold more than one rank, and every gated extent must divide by
    the rank count."""
    if mesh is None or not shard or mesh.size <= 1:
        return None
    if any(d % mesh.size != 0 for d in divisible):
        return None
    return mesh


def _account_pass_peaks(stats, stream, prefetch, *state_trees, devices: int = 1):
    state_b = tree_bytes(*state_trees)
    chunk_b = stream.chunk_bytes * stream.inflight_buffers(prefetch)
    stats.devices = max(stats.devices, devices)
    stats.peak_device_bytes = max(stats.peak_device_bytes, state_b + chunk_b)
    # Per rank: state replicated, chunk buffers split 1/D.
    stats.peak_local_bytes = max(stats.peak_local_bytes, state_b + chunk_b // devices)
    stats.peak_host_bytes = max(stats.peak_host_bytes, stream.host_bytes(prefetch))


def _restored(resume: dict, key: str, device):
    """A checkpointed host array as a tensor of its own on ``device``."""
    return torch.from_numpy(np.array(resume[key], copy=True)).to(device)


def stream_detect(stream: EdgeChunkStream, n_nodes: int, cfg: ScodaConfig, *,
                  device, prefetch: int = 1, stats: StreamStats | None = None,
                  mesh=None, shard: bool = False, put=None, tracer=None,
                  ckpt=None, resume: dict | None = None):
    """Multi-round SCoDA over the chunk stream; graph degrees are fused into
    the first pass. Returns (labels [n], scoda_deg [n], graph_deg [n]).
    ``tracer`` emits the ``detect``/``detect.round``/``detect.chunk`` span
    tree (None = process-global tracer).

    With ``mesh`` + ``shard`` each rank reads the within-block slice of
    every block (``block_chunk_spec``) and the updates run sharded
    (bitwise the single-rank ones, ``core/scoda.py``); any ``put`` is then
    superseded. It falls back to one rank unless the block size and the
    chunk size divide by the rank count.

    ``ckpt`` (a ``resilience.StreamCheckpointer``) is notified at every
    chunk boundary with the resume cursor — the (round, chunk) of the next
    unprocessed chunk, ``(r + 1, 0)`` at the end of round r — and a lazy
    payload of the detect state (``com``, ``deg`` and the graph-degree
    accumulator ``gdeg``, each [n+1]). ``resume`` is that payload plus the
    cursor (``{"round", "chunk", "com", "deg", "gdeg"}``, host arrays): the
    loops pick up exactly there, on any rank count."""
    tr = tracer if tracer is not None else get_tracer()
    device = torch.device(device)
    m = _effective_mesh(mesh, shard, cfg.block_size, stream.chunk_size)
    spec = block_chunk_spec(m, cfg.block_size) if m is not None else None
    d = m.size if m is not None else 1
    state = scoda_init(n_nodes, device)
    gdeg = torch.zeros(n_nodes + 1, dtype=torch.int32, device=device)
    start_round, start_chunk = 0, 0
    if resume is not None:
        start_round, start_chunk = int(resume["round"]), int(resume["chunk"])
        state = (_restored(resume, "com", device), _restored(resume, "deg", device))
        gdeg = _restored(resume, "gdeg", device)
    with tr.span("detect", rounds=cfg.rounds, chunk_size=stream.chunk_size, devices=d):
        for r in range(start_round, cfg.rounds):
            thr = round_threshold(cfg, r)
            c0 = start_chunk if r == start_round else 0
            with tr.span("detect.round", round=r):
                for i, chunk in enumerate(
                    stream.device_chunks(device, prefetch, stats, start=c0, spec=spec,
                                         put=None if m is not None else put),
                    start=c0,
                ):
                    with tr.span("detect.chunk", round=r, chunk=i):
                        if m is not None:
                            if r == 0:
                                gdeg = _sharded_degree_update(gdeg, chunk, m)
                            state = sharded_scoda_update(state, chunk, thr, cfg, m)
                        else:
                            if r == 0:
                                gdeg = _degree_update(gdeg, chunk)
                            state = scoda_update(state, chunk, thr, cfg)
                    if stats is not None:
                        stats.chunks += 1
                        stats.edges_streamed += chunk.shape[0] * d
                    if ckpt is not None:
                        last = i + 1 == stream.n_chunks
                        nr, nc = (r + 1, 0) if last else (r, i + 1)
                        ckpt.boundary("detect", nr, nc, last,
                                      lambda s=state, g=gdeg: {
                                          "com": s[0], "deg": s[1], "gdeg": g})
    if stats is not None:
        stats.passes += cfg.rounds - start_round
        _account_pass_peaks(stats, stream, prefetch, state, gdeg, devices=d)
    labels, scoda_deg = scoda_finalize(state, n_nodes, cfg)
    return labels, scoda_deg, gdeg[:n_nodes]


def stream_supergraph(stream: EdgeChunkStream, labels, node_deg, n_nodes: int,
                      s_cap: int, max_super_edges: int,
                      cms_cfg: cms_lib.CMSConfig, *, device, prefetch: int = 1,
                      stats: StreamStats | None = None,
                      with_modularity: bool = True, agg_backend: str = "merge",
                      mesh=None, shard: bool = False, put=None,
                      tracer=None, ckpt=None, resume: dict | None = None):
    """One fused pass: superedge aggregation + modularity accumulation.

    CMS community sizing is node-keyed (one sketch update per node, weight =
    graph degree) and so needs no edge pass. Returns (Supergraph, Q) with Q
    None when ``with_modularity`` is false.

    With ``mesh`` + ``shard`` each rank reads its contiguous C/D rows of
    every chunk (``row_chunk_spec``), and the aggregation, modularity and
    CMS updates run sharded (bitwise the single-rank ones); any ``put`` is
    then superseded. It falls back to one rank unless the chunk size
    divides by the rank count.

    ``ckpt``/``resume`` follow ``stream_detect``'s contract (cursor
    ``(0, i + 1)``). The payload carries the aggregation and modularity
    accumulators *and* the detect outputs (``labels``, graph degrees as
    ``deg``), so a run killed in this pass resumes without re-running
    detect; dense labels and the CMS sizes are recomputed from the labels.
    """
    tr = tracer if tracer is not None else get_tracer()
    device = torch.device(device)
    m = _effective_mesh(mesh, shard, stream.chunk_size)
    spec = row_chunk_spec(m) if m is not None else None
    d = m.size if m is not None else 1
    with tr.span("supergraph", chunk_size=stream.chunk_size, s_cap=s_cap,
                 agg_backend=agg_backend, devices=d):
        labels_dense, n_supernodes = dense_labels(labels, n_nodes)
        with tr.span("supergraph.sizes"):
            sizes = community_sizes(
                labels_dense, node_deg, n_supernodes, s_cap, cms_cfg, mesh=m
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
            stream.device_chunks(device, prefetch, stats, start=start_chunk, spec=spec,
                                 put=None if m is not None else put),
            start=start_chunk,
        ):
            with tr.span("supergraph.chunk", chunk=i):
                if m is not None:
                    agg = sharded_agg_update(agg, chunk, agg_ext, s_cap,
                                             max_super_edges, agg_backend, m)
                    if with_modularity:
                        mod = sharded_modularity_update(mod, chunk, mod_ext, m)
                else:
                    agg = agg_update(agg, chunk, agg_ext, s_cap, max_super_edges,
                                     agg_backend)
                    if with_modularity:
                        mod = modularity_update(mod, chunk, mod_ext)
            if stats is not None:
                stats.chunks += 1
                stats.edges_streamed += chunk.shape[0] * d
            if ckpt is not None:
                ckpt.boundary("supergraph", 0, i + 1, i + 1 == stream.n_chunks,
                              lambda a=agg, md=mod: payload(a, md))
    if stats is not None:
        stats.passes += 1
        _account_pass_peaks(
            stats, stream, prefetch, agg, mod, labels_dense, sizes, node_deg,
            devices=d,
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


def _find_resume(resume, checkpoint, fingerprint: str, mesh=None):
    """The newest checkpoint to resume from as ``(arrays, meta)``, or None.

    ``resume`` is True (the checkpointer's directory) or a directory path.
    A checkpoint without the resume cursor (its meta lost to a crash) is
    walked back past (and deleted); a fingerprint that differs from this
    run's raises. With a mesh rank 0 walks first, the others after it, so
    every rank reads the same file and none reads one being deleted."""
    if isinstance(resume, (str, os.PathLike)):
        ckpt_dir = os.fspath(resume)
    else:
        ckpt_dir = checkpoint.ckpt_dir if checkpoint is not None else None
    if not ckpt_dir:
        return None
    found = None
    if mesh is None or mesh.rank == 0:
        found = restore_latest_valid(ckpt_dir, valid=lambda a, m: "chunk" in m)
    if mesh is not None:
        barrier(mesh)
        if mesh.rank != 0:
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
                    resume=False, device=None, put=None):
    """Edge source → (labels, graph degrees, Supergraph, Q, StreamStats).

    ``source`` is anything ``as_edge_store`` accepts: a host NumPy array, an
    ``EdgeStore``, a path to a ``.npy``/``.bin`` edge file or shard
    directory, or a list of shard paths. ``device=None`` means CUDA, or the
    mesh's device when ``stream_cfg.mesh`` is set. ``put`` replaces the
    host→device copy of whole chunks in the passes that do not shard
    (``launch.stream_runner.StreamRunner.put``).

    With ``stream_cfg.mesh`` every rank calls this with the same arguments
    and gets the same result (see the module docstring): the mesh's
    ``shard_detect`` passes are bitwise the single-rank run's.

    ``checkpoint`` is a ``resilience.StreamCheckpointer``: the run then
    persists its streaming state at the checkpointer's cadence, stamped
    with this config's fingerprint (the reference's, so the packages
    resume each other's checkpoints). ``resume`` is False, True (the
    newest valid checkpoint under ``checkpoint.ckpt_dir``) or a directory
    path; a fingerprint mismatch raises ``CheckpointMismatchError``, and a
    resume with no checkpoint on disk starts fresh. A resumed run is
    bit-identical to an uninterrupted one.
    """
    store = as_edge_store(source)
    cfg = stream_cfg or StreamConfig(chunk_size=max(1, store.n_edges))
    mesh = cfg.mesh if cfg.mesh is not None and cfg.mesh.size > 1 else None
    device = resolve_device(device if device is not None or cfg.mesh is None
                            else cfg.mesh.device)
    tr = tracer if tracer is not None else (
        cfg.obs if cfg.obs is not None else get_tracer()
    )
    stream = EdgeChunkStream(store, n_nodes, cfg.chunk_size,
                             block_size=scoda_cfg.block_size, policy=cfg.validation,
                             mesh=mesh)
    stats = StreamStats(chunk_size=stream.chunk_size)
    fingerprint = config_fingerprint(
        n_nodes=n_nodes, n_edges=store.n_edges, chunk_size=stream.chunk_size,
        scoda=scoda_cfg, cms=cms_cfg, s_cap=s_cap,
        max_super_edges=max_super_edges, agg_backend=cfg.agg_backend,
        with_modularity=with_modularity,
    )
    if checkpoint is not None:
        checkpoint.fingerprint = fingerprint
        checkpoint.mesh = mesh
    resume_detect = resume_sg = None
    labels = gdeg = None
    found = _find_resume(resume, checkpoint, fingerprint, mesh) if resume else None
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
                stats=stats, mesh=cfg.mesh, shard=cfg.shard_detect, put=put,
                tracer=tr, ckpt=checkpoint, resume=resume_detect,
            )
            synchronize(device)
            stats.stage_seconds["detect_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sg, q = stream_supergraph(
            stream, labels, gdeg, n_nodes, s_cap, max_super_edges, cms_cfg,
            device=device, prefetch=cfg.prefetch, stats=stats,
            with_modularity=with_modularity, agg_backend=cfg.agg_backend,
            mesh=cfg.mesh, shard=cfg.shard_detect, put=put,
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
