"""Serving: the interactive tile-pyramid layout service (``tiles`` — pan
and zoom over a computed ``BGVResult``, with an LRU tile cache and
slot-batched re-renders on the device the result was computed on)."""
from repro_torch.serve.tiles import (
    DrillSpec,
    TileCache,
    TileConfig,
    TileEngine,
    TilePyramid,
    TileRequest,
    TileSpec,
    community_members,
    community_subgraph,
    error_tile,
    jit_compile_count,
    synthetic_trace,
)

__all__ = sorted([
    "DrillSpec", "TileCache", "TileConfig", "TileEngine", "TilePyramid",
    "TileRequest", "TileSpec", "community_members", "community_subgraph",
    "error_tile", "jit_compile_count", "synthetic_trace",
])
