"""K5's share of its roofline in the traced layout: the bound of its
launches over n nodes and the grid's cells (frozen costs, H100 SXM peaks)
over its device time. Kernel symbol read: ``far_field_kernel``."""
from bgvbench import costs, peaks

LAYER = "grid repulsion (kernels/grid, K5-K7)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fa2_layout_s"
KERNELS = ("far_field_kernel",)


def read(ctx):
    if ctx.trace is None or "grid_cells" not in ctx.shapes:
        return None
    launches, seconds = ctx.trace.kernel(*KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    bound = launches * peaks.bound_s(*costs.k5(ctx.shapes["n"], ctx.shapes["grid_cells"]))
    return 100.0 * bound / seconds
