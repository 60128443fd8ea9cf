"""Chunk placements and collectives of the multi-device paths.

* ``rules`` — which rows of a stream chunk each rank holds: contiguous C/D
  rows (``row_chunk_spec``, the supergraph pass) or the same within-block
  slice of every SCoDA block (``block_chunk_spec``, the detect pass), and
  the rank index (``linear_axis_index``).
* ``collectives`` — a tiled all-gather in rank order and all-reduces (sum,
  max, min), on the tensor's own device.
"""
from repro_torch.sharding.collectives import (
    all_gather_rows,
    all_reduce,
    any_rank,
    barrier,
)
from repro_torch.sharding.rules import (
    ChunkSpec,
    block_chunk_spec,
    linear_axis_index,
    row_chunk_spec,
)

__all__ = [
    "ChunkSpec",
    "all_gather_rows",
    "all_reduce",
    "any_rank",
    "barrier",
    "block_chunk_spec",
    "linear_axis_index",
    "row_chunk_spec",
]
