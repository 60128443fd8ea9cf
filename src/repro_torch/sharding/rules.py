"""Stream-chunk placements: which rows of a [C, 2] chunk a rank holds.

The counterpart of the reference's ``row_chunk_spec``/``block_chunk_spec``
(its ``sharding/rules.py``): there a ``PartitionSpec`` that XLA applies,
here the rows themselves, so that each rank reads only its own rows from
the edge source.

* rows (``row_chunk_spec``) — rank r holds rows ``[r·C/D, (r+1)·C/D)``: the
  supergraph, degree and modularity passes, whose updates merge by sums
  and by the concatenation of deduped runs.
* blocks (``block_chunk_spec``) — rank r holds rows ``[r·b/D, (r+1)·b/D)``
  of every SCoDA block of b rows, in block order: the detect pass, whose
  blocks must stay whole and in stream order.

Gathering every rank's rows in rank order (``collectives.all_gather_rows``)
rebuilds the chunk for the row placement, and each block for the block
placement. C (and b) must divide by D; the engine's gates fall back to one
rank otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
    tiled all-gather: the process group's rank (one mesh axis)."""
    return mesh.rank
