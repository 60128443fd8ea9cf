"""Placements and collectives of the multi-device paths.

* ``rules`` — which rows of a stream chunk each rank holds: contiguous C/D
  rows (``row_chunk_spec``, the supergraph pass) or the same within-block
  slice of every SCoDA block (``block_chunk_spec``, the detect pass), and
  the rank index (``linear_axis_index``); and the logical-axis rules of the
  model paths (``PROFILES``, ``P``, ``spec_for``, ``filter_spec``,
  ``params_shardings``, ``shardings_for_axes``, ``batch_sharding``).
* ``params`` — the block of a tensor each rank of a ``ModelMesh`` holds
  (``local_block``, ``shard_tree``, ``gather_tree``) and a model path's
  ``Placement``.
* ``collectives`` — a tiled all-gather in rank order and all-reduces (sum,
  max, min), on the tensor's own device; the same over named mesh axes, and
  the autograd Functions of the model paths (``gather_param``, ``copy_to``,
  ``reduce_from``, ``sum_shards``).
"""
from repro_torch.sharding.collectives import (
    all_gather_axes,
    all_gather_rows,
    all_reduce,
    all_reduce_axes,
    any_rank,
    barrier,
    copy_to,
    gather_param,
    reduce_from,
    sum_shards,
)
from repro_torch.sharding.params import Placement, gather_tree, local_block, shard_tree
from repro_torch.sharding.rules import (
    PROFILES,
    AbstractMesh,
    ChunkSpec,
    NamedSharding,
    P,
    batch_sharding,
    block_chunk_spec,
    filter_spec,
    linear_axis_index,
    params_shardings,
    row_chunk_spec,
    shardings_for_axes,
    spec_for,
)

__all__ = [
    "PROFILES",
    "AbstractMesh",
    "ChunkSpec",
    "NamedSharding",
    "P",
    "Placement",
    "all_gather_axes",
    "all_gather_rows",
    "all_reduce",
    "all_reduce_axes",
    "any_rank",
    "barrier",
    "batch_sharding",
    "block_chunk_spec",
    "copy_to",
    "filter_spec",
    "gather_param",
    "gather_tree",
    "linear_axis_index",
    "local_block",
    "params_shardings",
    "reduce_from",
    "row_chunk_spec",
    "shard_tree",
    "shardings_for_axes",
    "spec_for",
    "sum_shards",
]
