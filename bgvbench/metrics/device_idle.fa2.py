"""Share of a unit's time in which nothing ran on the card: one minus the
device's busy seconds in the traced unit (the union of its CUDA activity
in the profiler's trace) over the mean wall time of the window's untraced
units, so that the profiler's own cost on the host does not count as
idle."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fa2_layout_s"


def read(ctx):
    unit_s = ctx.mean("seconds")
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not unit_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / unit_s)
