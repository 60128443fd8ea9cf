"""Seconds a picture waited for a staging slot of the streaming engine
(``StreamStats.copy_stall_s``), mean over the window's untraced pictures."""
LAYER = "streaming engine (core/stream.py)"
UNIT = "s"
SOURCE = "program_counter"
MOVES = "picture_s"


def read(ctx):
    return ctx.mean("stream_wait_s")
