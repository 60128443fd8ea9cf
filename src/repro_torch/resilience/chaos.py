"""Deterministic fault injection for the streaming pipeline.

Everything here is seeded and addressable: faults fire at exact read
offsets or exact chunk boundaries, so a test can kill a run at chunk 7 of
round 1, resume it, and compare the result against the uninterrupted run —
no flaky timing, no monkeypatching.

* ``ChaosEdgeStore`` wraps any ``EdgeStore`` and injects I/O errors,
  truncated (short) reads, and bit-flips at reads starting on configured
  row offsets. ``transient_attempts`` makes a fault clear after that many
  failed attempts (exercising the retry path); 0 means permanent
  (exercising quarantine).
* ``KillSwitch`` raises ``SimulatedPreemption`` at the k-th chunk
  boundary — plug it into ``StreamCheckpointer.on_boundary`` to simulate a
  killed process at a deterministic point.
* ``poison_weights`` NaN-poisons layout inputs to exercise the FA2
  divergence sentinel (``FA2Config.nan_guard``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.edge_store import EdgeStore, as_edge_store


class SimulatedPreemption(RuntimeError):
    """The chaos analog of SIGKILL: the run stops here, mid-stream."""


@dataclass
class KillSwitch:
    """Raise ``SimulatedPreemption`` at the ``at_boundary``-th chunk
    boundary (0-based, counted across phases/rounds). Use as
    ``StreamCheckpointer(on_boundary=KillSwitch(k))``."""

    at_boundary: int
    fired: bool = field(default=False, repr=False)
    _seen: int = field(default=0, repr=False)

    def __call__(self, phase: str, rnd: int, chunk: int) -> None:
        if self._seen == self.at_boundary:
            self.fired = True
            raise SimulatedPreemption(
                f"killed at boundary {self._seen} "
                f"({phase} round {rnd} chunk {chunk})"
            )
        self._seen += 1


@dataclass(frozen=True)
class ChaosConfig:
    """Faults keyed by the *row offset a read starts at* (for the streaming
    engine that is ``chunk_index * chunk_size``, so chunk k of an engine
    with chunk size C is addressed as ``k * C``).

    ``transient_attempts`` = how many attempts at an offset fail before
    reads succeed (0 = every attempt fails, forever). ``truncate_rows`` =
    rows returned by a truncated read before it stops short."""

    seed: int = 0
    io_error_offsets: tuple = ()  # reads here raise OSError
    truncate_offsets: tuple = ()  # reads here come up short
    bitflip_offsets: tuple = ()  # reads here corrupt one node id
    transient_attempts: int = 0  # 0 = permanent faults
    truncate_rows: int = 0


class ChaosEdgeStore(EdgeStore):
    """An ``EdgeStore`` wrapper injecting the configured faults.

    Construction-time metadata (``n_edges``) is passed through unchanged —
    chaos models *read-time* corruption, the kind store-open validation
    cannot catch. ``injected`` records what actually fired, keyed by
    ``(kind, offset)``, so tests can assert the fault was exercised."""

    def __init__(self, inner, cfg: ChaosConfig):
        self.inner = as_edge_store(inner)
        self.cfg = cfg
        self.n_edges = self.inner.n_edges
        self._attempts: dict = {}
        self.injected: dict = {}

    def _fails(self, kind: str, start: int) -> bool:
        key = (kind, start)
        n = self._attempts.get(key, 0)
        self._attempts[key] = n + 1
        if self.cfg.transient_attempts and n >= self.cfg.transient_attempts:
            return False  # transient fault: cleared after N failed attempts
        self.injected[key] = self.injected.get(key, 0) + 1
        return True

    def read_into(self, start: int, out: np.ndarray) -> int:
        if start in self.cfg.io_error_offsets and self._fails("io", start):
            raise OSError(f"chaos: injected I/O error at row {start}")
        if start in self.cfg.truncate_offsets and self._fails("trunc", start):
            k = min(self.cfg.truncate_rows, len(out))
            self.inner.read_into(start, out[:k])
            return k
        k = self.inner.read_into(start, out)
        if start in self.cfg.bitflip_offsets and k and self._fails("flip", start):
            row, col = self.flip_position(start, k)
            out[row, col] |= np.int32(1 << 30)  # id blown out of range
        return k

    def flip_position(self, start: int, k: int) -> tuple[int, int]:
        """The (row within the read, column) a bit-flip at ``start`` hits
        when the read returns ``k`` rows — seeded, so a test can build the
        equivalent clean array."""
        rng = np.random.default_rng(self.cfg.seed + start)
        return int(rng.integers(0, k)), int(rng.integers(0, 2))

    @property
    def resident_bytes(self) -> int:
        return self.inner.resident_bytes


def poison_weights(weights, k: int = 1, seed: int = 0):
    """Return a copy of ``weights`` with ``k`` entries NaN-poisoned at
    seeded positions — feeds the FA2 attraction pass non-finite forces to
    exercise the ``nan_guard`` sentinel."""
    w = np.array(weights, dtype=np.float32, copy=True)
    if w.size == 0 or k <= 0:
        return w
    rng = np.random.default_rng(seed)
    idx = rng.choice(w.size, size=min(k, w.size), replace=False)
    w.flat[idx] = np.nan
    return w
