"""Placements of the multi-device paths: which block of a tensor a rank
holds.

Two kinds, the counterparts of the reference's ``sharding/rules.py``:

* Stream chunks (``row_chunk_spec``/``block_chunk_spec``): there a
  ``PartitionSpec`` that XLA applies, here the rows themselves, so that each
  rank reads only its own rows from the edge source.

  - rows (``row_chunk_spec``) — rank r holds rows ``[r·C/D, (r+1)·C/D)``:
    the supergraph, degree and modularity passes, whose updates merge by
    sums and by the concatenation of deduped runs.
  - blocks (``block_chunk_spec``) — rank r holds rows ``[r·b/D, (r+1)·b/D)``
    of every SCoDA block of b rows, in block order: the detect pass, whose
    blocks must stay whole and in stream order.

  Gathering every rank's rows in rank order
  (``collectives.all_gather_rows``) rebuilds the chunk for the row
  placement, and each block for the block placement. C (and b) must divide
  by D; the engine's gates fall back to one rank otherwise.

* Model parameters, optimizer state and batches (t5x/MaxText logical axes):
  every ``ParamSpec`` carries logical axis names, and a *profile* maps each
  logical axis to a tuple of mesh axes. ``spec_for`` resolves one tensor by
  the reference's three rules: each dim takes its mapped axes unless one of
  them is already used by an earlier dim of the same tensor, or the dim does
  not divide by their extent (then the dim stays whole); a mapping whose
  axes are all absent from the mesh or of extent 1 leaves the dim whole.
  ``P`` is the port's ``PartitionSpec``: a tuple with one entry a dim, each
  None, an axis name or a tuple of axis names. A mesh is anything with
  ``axis_names`` and a ``shape`` mapping each name to its extent
  (``launch.mesh.ModelMesh``, ``AbstractMesh``). ``sharding/params.py`` cuts
  the blocks.

Profiles:
  tp      — Megatron TP over "model" (heads/mlp/vocab/expert) + ZeRO-3-style
            parameter sharding of d_model ("embed") over every DP axis.
  fsdp    — weights sharded on embed→model and mlp/vocab→data; attention
            heads replicated (no registry arch uses it).
  gnn     — replicated parameters; nodes/edges sharded over all axes.
  recsys  — item table sharded on vocab→model; everything else replicated.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.param import is_spec


@dataclass(frozen=True)
class ChunkSpec:
    """Rank ``rank`` of ``size``'s rows of every chunk: contiguous when
    ``block`` is None, else the rank's slice of each ``block``-row block.
    ``mesh`` is the ``StreamMesh`` the rows are gathered over."""

    mesh: object
    block: int | None = None

    @property
    def rank(self) -> int:
        return linear_axis_index(self.mesh)

    @property
    def size(self) -> int:
        return self.mesh.size

    def local_rows(self, c: int) -> int:
        """Rows of a C-row chunk that this rank holds."""
        return c // self.size

    def runs(self, c: int) -> list[tuple[int, int]]:
        """This rank's rows of a C-row chunk as ``(start, stop)`` runs, in
        the order they are held."""
        if self.block is None:
            per = c // self.size
            return [(self.rank * per, (self.rank + 1) * per)]
        per = self.block // self.size
        return [(k + self.rank * per, k + (self.rank + 1) * per)
                for k in range(0, c, self.block)]

    def take(self, chunk: np.ndarray) -> np.ndarray:
        """This rank's rows of a host chunk (a view for the row placement)."""
        c = chunk.shape[0]
        if self.block is None:
            (a, b), = self.runs(c)
            return chunk[a:b]
        per = self.block // self.size
        return chunk.reshape(-1, self.block, 2)[:, self.rank * per:(self.rank + 1) * per]\
            .reshape(-1, 2)


def row_chunk_spec(mesh) -> ChunkSpec:
    """Contiguous C/D rows per rank (the supergraph-pass placement)."""
    return ChunkSpec(mesh)


def block_chunk_spec(mesh, block_size: int) -> ChunkSpec:
    """The same within-block slice of every ``block_size``-row block (the
    detect-pass placement): gathered, each block is whole again, so the
    block loop keeps the stream's block order."""
    return ChunkSpec(mesh, block_size)


def linear_axis_index(mesh) -> int:
    """The rank's index in the row order of the placements and of the
    tiled all-gather: the process group's rank (a ``StreamMesh``'s one
    axis, or a ``ModelMesh``'s axes row-major, the first axis major)."""
    return mesh.rank


# --------------------------------------------------------------------------
# Logical-axis rules of the model paths.
# --------------------------------------------------------------------------

PROFILES: dict[str, dict[str, tuple[str, ...]]] = {
    "tp": {
        "heads": ("model",),
        "expert": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        # ZeRO-3-style sharding of d_model over every DP axis (32-way,
        # pod×data, on the multi-pod mesh).
        "embed": ("pod", "data"),
    },
    "fsdp": {
        "embed": ("model",),
        "mlp": ("data",),
        "vocab": ("data",),
    },
    "gnn": {},
    "recsys": {
        "vocab": ("model",),
    },
}


class P(tuple):
    """A partition spec: one entry a dim, each None (whole), an axis name or
    a tuple of axis names (the dim split over their product, the first
    axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and extents without ranks: what the rules need."""

    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``, no devices)."""

    mesh: object
    spec: P


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first (() for None)."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec uses, in entry order."""
    return tuple(a for e in spec for a in entry_axes(e))


def filter_spec(spec, mesh) -> P:
    """Drop mesh axes that don't exist on this mesh (e.g. "pod" on a
    single-pod mesh)."""
    names = set(mesh.axis_names)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def spec_for(shape, axes, profile: dict, mesh) -> P:
    """One tensor's spec: its logical ``axes`` through ``profile`` onto
    ``mesh``, by the three rules of the module docstring."""
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        mapped = profile.get(ax)
        if mapped is None:
            out.append(None)
            continue
        cand = tuple(a for a in mapped if a in mesh.axis_names and a not in used)
        extent = 1
        for a in cand:
            extent *= mesh.shape[a]
        if cand and extent > 1 and dim % extent == 0:
            out.append(cand if len(cand) > 1 else cand[0])
            used.update(cand)
        else:
            out.append(None)
    return P(*out)


def _map2(fn, a, b):
    """``fn`` over the leaves of two nested dicts of one structure (``b``'s
    leaves may be tuples)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_shardings(specs, profile_name: str, mesh):
    """``ParamSpec`` tree → ``NamedSharding`` tree."""
    profile = PROFILES[profile_name]

    def one(s):
        if not is_spec(s):
            raise TypeError(f"params_shardings: a leaf is not a ParamSpec: {s!r}")
        return NamedSharding(mesh, spec_for(s.shape, s.logical_axes, profile, mesh))

    return _map_specs(one, specs)


def shardings_for_axes(abstract_tree, axes_tree, profile_name: str, mesh):
    """The same resolution for any tree of shaped leaves (tensors, ``meta``
    tensors) beside a tree of logical-axes tuples: the optimizer state."""
    profile = PROFILES[profile_name]

    def one(a, ax):
        return NamedSharding(mesh, spec_for(tuple(a.shape), ax, profile, mesh))

    return _map2(one, abstract_tree, axes_tree)


def batch_sharding(mesh, *specs):
    """``NamedSharding``s of batch specs, absent axes dropped."""
    return tuple(NamedSharding(mesh, filter_spec(s, mesh)) for s in specs)
