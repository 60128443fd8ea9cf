"""Streaming rasterization of (positions, sizes, groups, edges) to RGB on the
device (raster.py) and dependency-free PNG I/O (png.py)."""
from repro_torch.render.png import read_png, write_png
from repro_torch.render.raster import (
    RenderConfig,
    RenderStats,
    image_summary,
    render,
    render_arrays,
)
