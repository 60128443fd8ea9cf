"""K2's share of its roofline in the traced picture: the bound of its
launches at the layout's size (frozen costs, radii on, H100 SXM peaks)
over its device time. Kernel symbols read: ``repulsion_kernel`` (one a
launch) and ``sum_slices`` (its second pass)."""
from bgvbench import costs, peaks

LAYER = "supergraph layout (core/forceatlas2.py exact, K2, K7)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "picture_s"
KERNELS = ("repulsion_kernel", "sum_slices")


def read(ctx):
    if ctx.trace is None or "s_layout" not in ctx.shapes:
        return None
    launches, seconds = ctx.trace.kernel(*KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    bound = launches * peaks.bound_s(*costs.k2(ctx.shapes["s_layout"], True))
    return 100.0 * bound / seconds
