"""Seconds of the supergraph's ForceAtlas2 layout a picture
(``timings["layout_s"]``, ended by a synchronize)."""
LAYER = "supergraph layout (core/forceatlas2.py exact, K2, K7)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "picture_s"


def read(ctx):
    return ctx.mean("layout_s")
