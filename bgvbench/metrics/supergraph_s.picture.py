"""Seconds of the supergraph pass a picture (sizes, aggregation,
modularity; ``timings["supergraph_s"]``, ended by a synchronize)."""
LAYER = "aggregation (core/supergraph.py, core/cms.py, K1, K8)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "picture_s"


def read(ctx):
    return ctx.mean("supergraph_s")
