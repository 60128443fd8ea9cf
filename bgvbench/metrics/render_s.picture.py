"""Seconds of ``BGVResult.render`` a picture (``timings["render_s"]``,
ended by the image's copy to the host)."""
LAYER = "render (render/raster.py, K3, K4)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "picture_s"


def read(ctx):
    return ctx.mean("render_s")
