"""Out-of-core edge sources for the streaming engine (ROADMAP: "stream from
disk").

The paper's premise is that community detection needs only "a few passes on
the edge list" — so the edge list should never have to fit in device *or*
host memory. An ``EdgeStore`` is the engine's host-side edge source: a
random-access reader of ``[E, 2] int32`` edge rows that

* validates dtype/shape once, up front (``core/stream.py`` consumes any
  store without re-checking),
* exposes ``read_into(start, out)`` so readers fill caller-owned staging
  buffers (the double-buffered host→device pipeline reuses two fixed
  buffers; disk-backed stores never materialize the full list),
* reports ``resident_bytes`` — the host bytes the store itself pins.
  Memory-mapped stores report 0: their pages live in the OS page cache
  and are evicted under pressure, so host residency of a streamed run is
  the staging buffers alone, independent of |E|.

Concrete stores: ``InMemoryEdgeStore`` (NumPy array), ``NpyEdgeStore``
(memory-mapped ``.npy``), ``BinEdgeStore`` (raw little-endian int32 pairs),
``ShardedEdgeStore`` (concatenation of sub-stores, e.g. one file per
crawl shard). ``write_npy`` / ``write_bin`` / ``write_shards`` are the
streaming writers (chunked, so store→store conversion is itself
out-of-core). ``python -m repro_torch.data.edge_store info|convert`` is the
command-line inspector and converter.

This is the port's own copy of the reference package's edge-store module
(numpy only); files written by either package are read by both.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

EDGE_DTYPE = np.dtype(np.int32)
ROW_BYTES = 2 * EDGE_DTYPE.itemsize

MANIFEST_NAME = "manifest.json"


class EdgeStoreError(ValueError):
    """A source cannot be interpreted as an [E, 2] int32 edge list."""


class CorruptStoreError(EdgeStoreError):
    """A store's on-disk bytes contradict its declared layout — a truncated
    or trailing-garbage file, or shard sizes that don't sum to the declared
    edge count. The message names the file and byte offset of the damage."""


def _check_edge_shape(shape: tuple, what: str) -> None:
    if len(shape) != 2 or shape[1] != 2:
        raise EdgeStoreError(
            f"{what}: edge lists must have shape [E, 2], got {tuple(shape)}"
        )


class EdgeStore:
    """Random-access source of [E, 2] int32 edge rows.

    Subclasses set ``n_edges`` and implement ``read_into``. Construction
    validates dtype and shape once; every read after that is trusted.
    """

    n_edges: int = 0

    def read_into(self, start: int, out: np.ndarray) -> int:
        """Fill ``out`` (an [k, 2] int32 buffer) with rows ``start:start+k``.

        Returns the number of rows written — fewer than ``len(out)`` only
        at the tail. Rows past the end are left untouched (callers pad).
        """
        raise NotImplementedError

    def read(self, start: int, count: int) -> np.ndarray:
        """Convenience copy-out; prefer ``read_into`` on hot paths."""
        out = np.empty((count, 2), EDGE_DTYPE)
        k = self.read_into(start, out)
        return out[:k]

    @property
    def resident_bytes(self) -> int:
        """Host bytes this store pins (0 for page-cache-backed stores)."""
        return 0

    def __len__(self) -> int:
        return self.n_edges


class InMemoryEdgeStore(EdgeStore):
    """Edge list held as a host NumPy array.

    Accepts any integer dtype (converted to int32); floats and other
    non-integer dtypes are rejected here rather than producing silently
    truncated node ids deep inside a kernel.
    """

    def __init__(self, edges: np.ndarray):
        edges = np.asarray(edges)
        if not np.issubdtype(edges.dtype, np.integer):
            raise EdgeStoreError(
                f"edge arrays must have an integer dtype, got {edges.dtype} "
                "(float node ids would be silently truncated)"
            )
        if edges.size == 0:
            edges = edges.reshape(0, 2)
        _check_edge_shape(edges.shape, "in-memory edges")
        if edges.dtype.itemsize > EDGE_DTYPE.itemsize and edges.size:
            lo, hi = int(edges.min()), int(edges.max())
            if lo < np.iinfo(EDGE_DTYPE).min or hi > np.iinfo(EDGE_DTYPE).max:
                raise EdgeStoreError(
                    f"node ids span [{lo}, {hi}], outside int32 range — "
                    "converting would silently wrap them"
                )
        self.array = np.ascontiguousarray(edges, dtype=EDGE_DTYPE)
        self.n_edges = len(self.array)

    def read_into(self, start: int, out: np.ndarray) -> int:
        k = max(0, min(len(out), self.n_edges - start))
        out[:k] = self.array[start : start + k]
        return k

    @property
    def resident_bytes(self) -> int:
        return self.array.nbytes


class NpyEdgeStore(EdgeStore):
    """Memory-mapped ``.npy`` edge file; the file is the backing store."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        try:
            mm = np.load(self.path, mmap_mode="r")
        except ValueError as e:
            # Bad/truncated header, or data section shorter than the header
            # declares (np.memmap refuses to map past EOF in mode "r").
            raise CorruptStoreError(
                f"{self.path}: truncated or corrupt .npy "
                f"(file ends at byte {os.path.getsize(self.path)}): {e}"
            ) from e
        _check_edge_shape(mm.shape, self.path)
        if mm.dtype != EDGE_DTYPE:
            raise EdgeStoreError(
                f"{self.path}: mmap edge files must be int32, got {mm.dtype} "
                "(convert with `write_npy`)"
            )
        # The header declares the shape; verify the file actually holds that
        # many bytes (np.load would otherwise mmap short and fault on read).
        need = mm.offset + mm.size * mm.itemsize
        have = os.path.getsize(self.path)
        if have < need:
            raise CorruptStoreError(
                f"{self.path}: truncated — header declares {len(mm)} edges "
                f"({need} bytes) but the file ends at byte {have}"
            )
        self._mm = mm
        self.n_edges = len(mm)

    def read_into(self, start: int, out: np.ndarray) -> int:
        k = max(0, min(len(out), self.n_edges - start))
        out[:k] = self._mm[start : start + k]
        return k


class BinEdgeStore(EdgeStore):
    """Raw binary edge file: little-endian int32 (src, dst) pairs."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        size = os.path.getsize(self.path)
        if size % ROW_BYTES:
            raise CorruptStoreError(
                f"{self.path}: size {size} is not a multiple of {ROW_BYTES} "
                f"bytes (int32 src,dst pairs) — trailing partial record "
                f"starts at byte {size - size % ROW_BYTES}"
            )
        self.n_edges = size // ROW_BYTES
        self._mm = (
            np.memmap(self.path, dtype=EDGE_DTYPE, mode="r").reshape(-1, 2)
            if size
            else np.empty((0, 2), EDGE_DTYPE)
        )

    def read_into(self, start: int, out: np.ndarray) -> int:
        k = max(0, min(len(out), self.n_edges - start))
        out[:k] = self._mm[start : start + k]
        return k


class ShardedEdgeStore(EdgeStore):
    """Concatenation of sub-stores (one file per shard); empty shards ok."""

    def __init__(self, stores, expected_edges: int | None = None):
        self.stores = [as_edge_store(s) for s in stores]
        if not self.stores:
            raise EdgeStoreError("sharded store needs at least one shard")
        self.offsets = np.cumsum([0] + [s.n_edges for s in self.stores])
        self.n_edges = int(self.offsets[-1])
        if expected_edges is not None and self.n_edges != expected_edges:
            raise CorruptStoreError(
                f"sharded store: shard sizes sum to {self.n_edges} edges but "
                f"{expected_edges} were declared — shard rows "
                f"{[int(s.n_edges) for s in self.stores]}"
            )

    def read_into(self, start: int, out: np.ndarray) -> int:
        want = max(0, min(len(out), self.n_edges - start))
        done = 0
        # First shard containing row `start`: offsets is sorted, searchsorted
        # with side="right" lands past every shard that ends at/before start.
        i = int(np.searchsorted(self.offsets, start, side="right")) - 1
        i = max(0, i)
        while done < want and i < len(self.stores):
            local = start + done - int(self.offsets[i])
            done += self.stores[i].read_into(local, out[done:want])
            i += 1
        return done

    @property
    def resident_bytes(self) -> int:
        return sum(s.resident_bytes for s in self.stores)


def _open_manifest_shards(p: Path, manifest_path: Path) -> EdgeStore:
    """Open a shard directory against its ``manifest.json`` (written by
    ``write_shards``): every listed shard must exist and hold exactly its
    declared row count, and the totals must agree — a missing, truncated,
    or swapped shard raises ``CorruptStoreError`` naming file and offset
    instead of silently streaming a shorter edge list."""
    with open(manifest_path) as f:
        manifest = json.load(f)
    stores = []
    for entry in manifest["shards"]:
        q = p / entry["file"]
        if not q.exists():
            raise CorruptStoreError(
                f"{p}: shard {entry['file']} is listed in {MANIFEST_NAME} "
                f"({entry['edges']} edges) but missing on disk"
            )
        s = open_edge_store(q)
        if s.n_edges != entry["edges"]:
            raise CorruptStoreError(
                f"{q}: holds {s.n_edges} edges but {MANIFEST_NAME} declares "
                f"{entry['edges']} — file diverges at byte "
                f"{min(s.n_edges, entry['edges']) * ROW_BYTES} of the data"
            )
        stores.append(s)
    return ShardedEdgeStore(stores, expected_edges=manifest["total_edges"])


def open_edge_store(path: str | os.PathLike) -> EdgeStore:
    """Open a path as a store: ``.npy`` → mmap, directory → sharded (its
    ``manifest.json`` verified when present, sorted ``.npy``/``.bin`` files
    otherwise), anything else → raw int32-pair binary."""
    p = Path(path)
    if p.is_dir():
        manifest = p / MANIFEST_NAME
        if manifest.exists():
            return _open_manifest_shards(p, manifest)
        shards = sorted(q for q in p.iterdir() if q.suffix in (".npy", ".bin"))
        if not shards:
            raise EdgeStoreError(f"{p}: no .npy/.bin shard files found")
        return ShardedEdgeStore([open_edge_store(q) for q in shards])
    if not p.exists():
        raise EdgeStoreError(f"{p}: no such edge file")
    if p.suffix == ".npy":
        return NpyEdgeStore(p)
    return BinEdgeStore(p)


def as_edge_store(source) -> EdgeStore:
    """Coerce an engine edge source: EdgeStore (as-is), NumPy array
    (in-memory), str/path (``open_edge_store``), list of paths (sharded)."""
    if isinstance(source, EdgeStore):
        return source
    if isinstance(source, np.ndarray):
        return InMemoryEdgeStore(source)
    if isinstance(source, (str, os.PathLike)):
        return open_edge_store(source)
    if isinstance(source, (list, tuple)):
        return ShardedEdgeStore(source)
    raise EdgeStoreError(
        f"cannot interpret {type(source).__name__} as an edge source "
        "(expected ndarray, EdgeStore, path, or list of paths)"
    )


# ------------------------------------------------------------------ writers


DEFAULT_WRITE_CHUNK = 1 << 20  # rows per copy step: out-of-core conversion


def _chunks(store: EdgeStore, chunk_rows: int):
    buf = np.empty((max(1, chunk_rows), 2), EDGE_DTYPE)
    for start in range(0, store.n_edges, len(buf)):
        k = store.read_into(start, buf)
        yield buf[:k]


def write_npy(path, source, chunk_rows: int = DEFAULT_WRITE_CHUNK) -> str:
    """Stream ``source`` into a ``.npy`` file readable by ``NpyEdgeStore``.

    Uses a preallocated memmap target so the writer's host footprint is one
    chunk buffer regardless of |E|.
    """
    store = as_edge_store(source)
    path = os.fspath(path)
    out = np.lib.format.open_memmap(
        path, mode="w+", dtype=EDGE_DTYPE, shape=(store.n_edges, 2)
    )
    done = 0
    for chunk in _chunks(store, chunk_rows):
        out[done : done + len(chunk)] = chunk
        done += len(chunk)
    out.flush()
    del out
    return path


def write_bin(path, source, chunk_rows: int = DEFAULT_WRITE_CHUNK) -> str:
    """Stream ``source`` into a raw little-endian int32-pair file."""
    store = as_edge_store(source)
    path = os.fspath(path)
    with open(path, "wb") as f:
        for chunk in _chunks(store, chunk_rows):
            f.write(np.ascontiguousarray(chunk).tobytes())
    return path


def write_shards(
    directory,
    source,
    shard_edges: int,
    fmt: str = "npy",
    chunk_rows: int = DEFAULT_WRITE_CHUNK,
) -> list:
    """Split ``source`` into ``shard-NNNNN.{npy,bin}`` files of at most
    ``shard_edges`` rows each, plus a ``manifest.json`` declaring per-shard
    and total edge counts (verified on open — a shard lost or truncated
    after writing raises ``CorruptStoreError`` instead of streaming a
    silently shorter edge list); returns the shard paths."""
    if shard_edges < 1:
        raise EdgeStoreError(f"shard_edges must be positive, got {shard_edges}")
    store = as_edge_store(source)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    writer = {"npy": write_npy, "bin": write_bin}[fmt]
    paths = []
    entries = []
    n_shards = max(1, -(-store.n_edges // shard_edges))
    for i in range(n_shards):
        view = _StoreSlice(store, i * shard_edges, shard_edges)
        paths.append(writer(directory / f"shard-{i:05d}.{fmt}", view, chunk_rows))
        entries.append({"file": f"shard-{i:05d}.{fmt}", "edges": view.n_edges})
    with open(directory / MANIFEST_NAME, "w") as f:
        json.dump({"total_edges": store.n_edges, "shards": entries}, f, indent=2)
    return paths


class _StoreSlice(EdgeStore):
    """Zero-copy row-range view of another store (shard writer plumbing)."""

    def __init__(self, store: EdgeStore, start: int, count: int):
        self.store = store
        self.start = start
        self.n_edges = max(0, min(count, store.n_edges - start))

    def read_into(self, start: int, out: np.ndarray) -> int:
        k = max(0, min(len(out), self.n_edges - start))
        return self.store.read_into(self.start + start, out[:k])


# ---------------------------------------------------------------- converter


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="repro_torch.data.edge_store",
        description="Inspect and convert on-disk edge stores.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    info = sub.add_parser("info", help="print a store's shape and layout")
    info.add_argument("path")

    conv = sub.add_parser(
        "convert", help="convert between npy / bin / sharded edge stores"
    )
    conv.add_argument("src", help="input: .npy, raw .bin, or shard directory")
    conv.add_argument("dst", help="output file (or directory for shards)")
    conv.add_argument(
        "--format",
        choices=("npy", "bin", "shards"),
        default=None,
        help="output format (default: from dst extension)",
    )
    conv.add_argument(
        "--shard-edges",
        type=int,
        default=1 << 20,
        help="rows per shard when --format shards",
    )
    conv.add_argument(
        "--chunk-rows",
        type=int,
        default=DEFAULT_WRITE_CHUNK,
        help="copy-buffer rows (host footprint of the conversion)",
    )
    args = ap.parse_args(argv)

    if args.cmd == "info":
        store = open_edge_store(args.path)
        kind = type(store).__name__
        print(f"{args.path}: {store.n_edges} edges ({kind})")
        print(f"bytes on disk ≈ {store.n_edges * ROW_BYTES:,}")
        print(f"host resident bytes = {store.resident_bytes:,}")
        if isinstance(store, ShardedEdgeStore):
            for s, e in zip(store.stores, np.diff(store.offsets)):
                print(f"  shard {getattr(s, 'path', '?')}: {int(e)} edges")
        return

    fmt = args.format or ("npy" if args.dst.endswith(".npy") else "bin")
    store = open_edge_store(args.src)
    if fmt == "shards":
        paths = write_shards(
            args.dst, store, args.shard_edges, chunk_rows=args.chunk_rows
        )
        print(f"wrote {len(paths)} shards under {args.dst}")
    elif fmt == "npy":
        print("wrote", write_npy(args.dst, store, chunk_rows=args.chunk_rows))
    else:
        print("wrote", write_bin(args.dst, store, chunk_rows=args.chunk_rows))


if __name__ == "__main__":
    main()
