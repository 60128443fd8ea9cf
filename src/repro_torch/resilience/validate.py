"""Input validation and quarantine at the EdgeStore/EdgeChunkStream boundary.

The streaming engine trusts its stores after construction-time dtype/shape
checks — correct for clean data, fatal for an ingest path where a crawler
shard can be truncated mid-write, an NFS read can fail transiently, or a
bit-flip can push a node id out of range. ``ValidationPolicy`` +
``validated_read`` make the per-chunk read defensive without touching the
chunk-update bodies:

* transient I/O errors (``OSError``) and short reads are retried with
  doubling backoff up to ``max_retries`` times;
* a chunk that still cannot be read is **quarantined**: its buffer is
  filled with the trash node (a no-op for every chunk-update body), its
  index is recorded, and the run continues — surfaced in ``StreamStats``
  and the ``errors.*`` counters instead of crashing a multi-pass run;
* rows that read fine but are *invalid* (node ids outside ``[0, n_nodes]``,
  optionally self-loops) are dropped to the trash node (or raised on, per
  policy) and counted.

Every counter increments at the point of occurrence — publish paths only
mirror totals, so nothing double-counts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs.metrics import REGISTRY, ensure_error_counters


class ValidationError(ValueError):
    """A chunk contained invalid rows and the policy said error, not drop."""


@dataclass(frozen=True)
class ValidationPolicy:
    """Defensive-read policy for ``EdgeChunkStream``.

    ``self_loops``: "keep" (SCoDA ignores them anyway), "drop" (to trash),
    or "error". ``on_invalid`` governs out-of-range node ids: "drop" or
    "error". ``quarantine`` False turns exhausted-retry chunks into raised
    ``OSError`` instead of trash-filled buffers."""

    check_range: bool = True
    self_loops: str = "keep"  # keep | drop | error
    on_invalid: str = "drop"  # drop | error
    max_retries: int = 2
    retry_backoff_s: float = 0.01
    quarantine: bool = True

    def __post_init__(self):
        if self.self_loops not in ("keep", "drop", "error"):
            raise ValueError(f"self_loops: bad value {self.self_loops!r}")
        if self.on_invalid not in ("drop", "error"):
            raise ValueError(f"on_invalid: bad value {self.on_invalid!r}")


@dataclass
class ValidationAccounting:
    """Mutable per-run tally, mirrored into ``StreamStats`` by the engine."""

    retries: int = 0
    quarantined: list = field(default_factory=list)  # chunk indices
    dropped_edges: int = 0


def _read_full(store, start: int, want: int, buf: np.ndarray) -> None:
    """One read attempt; a short read (truncation landed mid-chunk) is
    promoted to OSError with the byte offset so retry/quarantine applies."""
    k = store.read_into(start, buf[:want])
    if k < want:
        raise OSError(
            f"short read: got {k} of {want} rows at row {start} "
            f"(byte offset {(start + k) * 8})"
        )


def validated_read(
    store,
    chunk_index: int,
    chunk_size: int,
    buf: np.ndarray,
    n_nodes: int,
    policy: ValidationPolicy,
    acct: ValidationAccounting,
    registry=None,
) -> np.ndarray:
    """Fill ``buf`` with chunk ``chunk_index`` defensively (see module doc).

    Always returns a fully-populated [chunk_size, 2] buffer whose every row
    is either a valid edge or the trash pair ``(n_nodes, n_nodes)`` — the
    same contract as the trusting read, so downstream updates are
    unchanged. ``buf`` is written, trash included: it must be a staging
    buffer, never a view of the caller's edge array.
    """
    reg = registry if registry is not None else REGISTRY
    ensure_error_counters(reg)
    start = chunk_index * chunk_size
    want = min(chunk_size, store.n_edges - start)

    err = None
    for attempt in range(policy.max_retries + 1):
        try:
            _read_full(store, start, want, buf)
            err = None
            break
        except OSError as e:
            err = e
            if attempt < policy.max_retries:
                acct.retries += 1
                reg.counter("errors.io_retries").inc()
                time.sleep(policy.retry_backoff_s * (2 ** attempt))
    if err is not None:
        if not policy.quarantine:
            raise err
        buf[:] = n_nodes  # all-trash chunk: a no-op for every update body
        acct.quarantined.append(chunk_index)
        reg.counter("errors.quarantined_chunks").inc()
        return buf

    if want < chunk_size:
        buf[want:] = n_nodes  # normal tail padding

    live = buf[:want]
    bad = np.zeros(want, dtype=bool)
    if policy.check_range:
        bad |= ((live < 0) | (live > n_nodes)).any(axis=1)
    if policy.self_loops != "keep":
        loops = (live[:, 0] == live[:, 1]) & (live[:, 0] != n_nodes)
        if policy.self_loops == "error" and loops.any():
            raise ValidationError(
                f"chunk {chunk_index}: {int(loops.sum())} self-loop rows "
                f"(first at row {start + int(np.argmax(loops))})"
            )
        bad |= loops
    n_bad = int(bad.sum())
    if n_bad:
        if policy.on_invalid == "error":
            first = start + int(np.argmax(bad))
            raise ValidationError(
                f"chunk {chunk_index}: {n_bad} invalid rows "
                f"(node id outside [0, {n_nodes}]; first at row {first})"
            )
        live[bad] = n_nodes  # drop to trash
        acct.dropped_edges += n_bad
        reg.counter("errors.invalid_edges").inc(n_bad)
    return buf
