"""Checkpoint save/restore and the streaming checkpointer.

Format (shared with the reference package, so either package reads what
the other writes): one ``step_%08d.npz`` per checkpoint holding the
flattened state under ``/``-joined path keys (dict keys as written, list
and tuple positions as their index), plus ``step_%08d.npz.meta.json``
(``step``, and for the streaming engine ``phase``/``round``/``chunk`` and
the config ``fingerprint``). Writes are atomic (tmp + rename, the meta
before the npz) and a keep-last-k window is enforced — the two properties
that make checkpoint/restart safe under preemption.

Arrays are stored on the host, unsharded; ``restore`` places every leaf on
the device asked for, or on the device of the matching leaf of ``like``.

``StreamCheckpointer`` is the engine-facing half: ``core/stream.py`` calls
``boundary()`` after every completed chunk update, and the checkpointer
decides whether to persist (every ``every_chunks`` boundaries, at round
boundaries when ``every_chunks`` is 0, or right after a SIGTERM —
``install_preemption_handler``). ``on_boundary`` is the fault-injection
hook (``resilience/chaos.KillSwitch``).
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import tempfile
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

SEP = "/"


class Preempted(RuntimeError):
    """Raised at a chunk boundary after the preemption-triggered checkpoint
    was written (``StreamCheckpointer.exit_on_preempt``) — the launcher
    catches it and exits cleanly; ``--resume`` picks the run back up."""


class CheckpointMismatchError(RuntimeError):
    """A checkpoint's config fingerprint does not match the resuming run —
    resuming would silently produce garbage, so it is an error instead."""


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict/list/tuple, dict keys sorted
    (the reference's tree order); None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, prefix + (str(i),))
    else:
        yield SEP.join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: keep the bits
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         keep: int = 3) -> str:
    """Atomically write checkpoint ``step``; prune to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _leaves(tree)}
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd)
    fd_m, tmp_meta = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    os.close(fd_m)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        # Meta lands (atomically) BEFORE the npz rename: a kill between the
        # two leaves an orphaned meta (invisible — discovery keys off .npz)
        # rather than a meta-less npz that readers would mis-trust.
        meta = {"step": step, **(extra or {})}
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
        os.replace(tmp_meta, final + ".meta.json")
        os.replace(tmp, final)  # atomic on POSIX
    finally:
        for t in (tmp, tmp_meta):
            if os.path.exists(t):
                os.unlink(t)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    names = os.listdir(ckpt_dir)
    ckpts = sorted(f for f in names if f.startswith("step_") and f.endswith(".npz"))
    for old in ckpts[:-keep]:
        os.unlink(os.path.join(ckpt_dir, old))
        meta = os.path.join(ckpt_dir, old + ".meta.json")
        if os.path.exists(meta):
            os.unlink(meta)
    # Orphaned metas (kill before the npz rename, pruned/corrupt npz).
    for f in names:
        if (f.startswith("step_") and f.endswith(".npz.meta.json")
                and not os.path.exists(os.path.join(ckpt_dir, f[: -len(".meta.json")]))):
            try:
                os.unlink(os.path.join(ckpt_dir, f))
            except FileNotFoundError:
                pass


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(f[len("step_"): -len(".npz")])
        for f in os.listdir(ckpt_dir)
        if f.startswith("step_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def _read_meta(path: str) -> dict:
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like: Any, device=None):
    """Rebuild the nested dict/list/tuple ``like`` (of tensors, or of
    anything with ``shape`` and ``dtype``) from checkpoint ``step``.
    Returns ``(tree, meta)``. Every leaf lands on ``device``, or with
    ``device=None`` on the device of its ``like`` leaf (the host for a
    leaf that is not a tensor) — a restore onto another device is the
    same call."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        def build(node, prefix=()):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: build(node[k], prefix + (str(k),)) for k in node}
            if isinstance(node, (list, tuple)):
                out = [build(x, prefix + (str(i),)) for i, x in enumerate(node)]
                return type(node)(out) if isinstance(node, tuple) else out
            key = SEP.join(prefix)
            arr = data[key]
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                                 f"expected {tuple(node.shape)}")
            want = node.dtype
            if want == torch.bfloat16 and arr.dtype == np.uint16:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr, copy=True))
            dev = device if device is not None else (
                node.device if isinstance(node, torch.Tensor) else "cpu")
            return t.to(dev)

        tree = build(like)
    return tree, _read_meta(path)


def load_arrays(ckpt_dir: str, step: int) -> tuple[dict, dict]:
    """Load checkpoint ``step`` as a flat ``{key: host ndarray}`` dict plus
    its meta — the shape-agnostic reader the streaming resume path uses."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, _read_meta(path)


def restore_latest_valid(
    ckpt_dir: str,
    valid: Callable[[dict, dict], bool] | None = None,
) -> tuple[dict, dict] | None:
    """Newest loadable checkpoint as ``(arrays, meta)``, or None if the
    directory holds none. A corrupt newest file is deleted — npz and its
    meta together — and the walk continues back through the keep-last-k
    window. ``valid(arrays, meta)`` lets callers demand semantic
    completeness (the stream resume cursor) with the same walk-back."""
    step = latest_step(ckpt_dir)
    while step is not None:
        try:
            arrays, meta = load_arrays(ckpt_dir, step)
            if valid is None or valid(arrays, meta):
                return arrays, meta
        except Exception:  # partial/corrupt → try the previous one
            pass
        path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
        for p in (path, path + ".meta.json"):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass
        step = latest_step(ckpt_dir)
    return None


def config_fingerprint(**kwargs) -> str:
    """Short sha256 over the repr of the run parameters that must match for
    a resume to be bit-identical (graph extents, chunk size, stage configs).
    Dataclass reprs are deterministic, so equal configs hash equal — and
    the port's configs repr like the reference's, so the two packages'
    fingerprints agree."""
    blob = json.dumps({k: repr(v) for k, v in sorted(kwargs.items())}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass
class StreamCheckpointer:
    """Chunk-boundary checkpoint cadence + SIGTERM handling for the
    streaming engine (``core/stream.py`` calls ``boundary`` after every
    completed chunk update; ``stream_pipeline(..., resume=)`` restores).

    ``every_chunks`` > 0 saves every that-many boundaries; 0 saves at
    round/pass boundaries only. A SIGTERM (``install_preemption_handler``)
    forces a save at the next boundary regardless of cadence, and with
    ``exit_on_preempt`` raises ``Preempted`` right after it.

    ``fingerprint`` is stamped into every meta.json; ``stream_pipeline``
    fills it from its own config and refuses to resume from a checkpoint
    whose fingerprint differs (``CheckpointMismatchError``).

    ``on_boundary(phase, round, chunk)`` fires at *every* boundary, after
    any save (``resilience.chaos.KillSwitch``).

    ``host_s`` and ``write_s`` add up the seconds of the saves: taking the
    payload to the host (which waits for the device's queued work) and
    writing the npz; ``last_bytes`` is the size of the last payload.

    ``mesh`` (a ``launch.mesh.StreamMesh`` of several ranks; set by
    ``stream_pipeline`` from its config) makes the checkpointer one of a
    group: every rank calls ``boundary`` at the same boundaries, a SIGTERM
    seen by any rank is agreed by all before any acts on it, rank 0 alone
    writes (the state is replicated, and stored unsharded as in the
    reference), and the others wait at a barrier until the file is there.
    Every rank counts the save.
    """

    ckpt_dir: str
    every_chunks: int = 0
    keep: int = 3
    fingerprint: str = ""
    exit_on_preempt: bool = False
    on_boundary: Callable | None = None
    mesh: object = None
    _seq: int = field(default=0, repr=False)
    _preempted: bool = field(default=False, repr=False)
    saves: int = field(default=0, repr=False)
    host_s: float = field(default=0.0, repr=False)
    write_s: float = field(default=0.0, repr=False)
    last_bytes: int = field(default=0, repr=False)

    def install_preemption_handler(self) -> None:
        """SIGTERM (the cloud/cluster preemption signal) ⇒ checkpoint at
        the next chunk boundary. Call from the main thread.

        The handler holds the checkpointer weakly: the signal table lives
        until the interpreter exits, and a checkpointer kept there would
        keep its mesh's process group alive into the interpreter's
        teardown, where destroying gloo's group can abort the process
        after a clean run."""
        ref = weakref.ref(self)

        def handler(signum, frame):
            ckpt = ref()
            if ckpt is not None:
                ckpt._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def want_save(self, at_round_boundary: bool) -> bool:
        if self._preempted:
            return True
        if self.every_chunks > 0:
            return self._seq % self.every_chunks == 0
        return at_round_boundary

    def boundary(self, phase: str, rnd: int, chunk: int,
                 at_round_boundary: bool, payload: Callable[[], dict]) -> None:
        """One completed chunk update. ``(rnd, chunk)`` is the *resume
        cursor* (the next unprocessed chunk, round-boundary normalized);
        ``payload`` lazily materializes the host-side state dict so
        non-saving boundaries cost nothing."""
        self._seq += 1
        # Consume the flag before saving: a SIGTERM that lands during the
        # save (where a boundary spends most of its time) stays pending for
        # the next boundary instead of being cleared by it.
        preempted, self._preempted = self._preempted, False
        if self.mesh is not None:
            from repro_torch.sharding.collectives import any_rank

            preempted = any_rank(preempted, self.mesh)
        if preempted or self.want_save(at_round_boundary):
            if self.mesh is None or self.mesh.rank == 0:
                t0 = time.perf_counter()
                arrays = {k: _to_numpy(v) for k, v in payload().items()}
                self.host_s += time.perf_counter() - t0
                self.save(phase, rnd, chunk, arrays)
            if self.mesh is not None:
                from repro_torch.sharding.collectives import barrier

                if self.mesh.rank != 0:
                    self.saves += 1
                barrier(self.mesh)
        if preempted and self.exit_on_preempt:
            raise Preempted(
                f"preempted: checkpoint written at {phase} round {rnd} "
                f"chunk {chunk} under {self.ckpt_dir}"
            )
        if self.on_boundary is not None:
            self.on_boundary(phase, rnd, chunk)

    def save(self, phase: str, rnd: int, chunk: int, arrays: dict) -> str:
        arrays = {k: _to_numpy(v) for k, v in arrays.items()}
        t0 = time.perf_counter()
        path = save(
            self.ckpt_dir, self._seq, arrays,
            extra={"phase": phase, "round": rnd, "chunk": chunk,
                   "fingerprint": self.fingerprint},
            keep=self.keep,
        )
        self.write_s += time.perf_counter() - t0
        self.last_bytes = sum(a.nbytes for a in arrays.values())
        self.saves += 1
        return path

    def seed(self, meta: dict) -> None:
        """Continue the save sequence past a restored checkpoint's step, so
        that post-resume saves are not pruned on arrival under the pre-kill
        ``step_`` files still on disk."""
        self._seq = max(self._seq, int(meta.get("step", 0)))

    def restore_latest(self) -> tuple[dict, dict] | None:
        found = restore_latest_valid(self.ckpt_dir)
        if found is not None:
            self.seed(found[1])
        return found
