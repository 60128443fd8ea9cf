"""Seconds of SCoDA's passes a picture (``timings["scoda_s"]``, ended by a
device synchronize), mean over the window's untraced pictures."""
LAYER = "detection (core/scoda.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "picture_s"


def read(ctx):
    return ctx.mean("detect_s")
