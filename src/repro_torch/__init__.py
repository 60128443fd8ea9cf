"""BigGraphVis on PyTorch and CUDA — the port of the reference package
``src/repro`` to one NVIDIA H100, with its accelerator kernels written by
hand for Hopper (``csrc/``).

The entry points of this slice, re-exported from their implementation
modules:

    from repro_torch import biggraphvis, default_config, render

* pipeline — ``biggraphvis`` / ``default_config`` / ``BGVConfig`` /
  ``BGVResult`` (with ``BGVResult.render``) / ``full_layout_colored`` /
  ``layout``
* streaming engine — ``stream_pipeline`` / ``StreamConfig`` /
  ``StreamStats`` / ``EdgeStore`` sources (``as_edge_store``)
* rendering — ``render`` / ``render_arrays`` / ``RenderConfig``
* serving — ``TileEngine`` / ``TilePyramid`` / ``TileConfig`` /
  ``TileSpec`` / ``DrillSpec`` (``serve/tiles.py``)
* observability — ``Tracer`` / ``MetricsRegistry`` / ``enable_tracing`` /
  ``get_tracer`` / ``jit_compile_count`` (kernel builds and loads)

Every entry point takes ``device=None``, which means CUDA and raises where
there is none; pass ``device="cpu"`` to run the plain PyTorch versions.
Imports are lazy (PEP 562), so ``import repro_torch`` stays cheap.
"""
import importlib

_EXPORTS = {
    "BGVConfig": "repro_torch.core.pipeline",
    "BGVResult": "repro_torch.core.pipeline",
    "DrillSpec": "repro_torch.serve.tiles",
    "EdgeStore": "repro_torch.data.edge_store",
    "MetricsRegistry": "repro_torch.obs",
    "RenderConfig": "repro_torch.render",
    "StreamConfig": "repro_torch.core.stream",
    "StreamStats": "repro_torch.core.stream",
    "TileConfig": "repro_torch.serve.tiles",
    "TileEngine": "repro_torch.serve.tiles",
    "TilePyramid": "repro_torch.serve.tiles",
    "TileSpec": "repro_torch.serve.tiles",
    "Tracer": "repro_torch.obs",
    "as_edge_store": "repro_torch.data.edge_store",
    "biggraphvis": "repro_torch.core.pipeline",
    "default_config": "repro_torch.core.pipeline",
    "enable_tracing": "repro_torch.obs",
    "full_layout_colored": "repro_torch.core.pipeline",
    "get_tracer": "repro_torch.obs",
    "jit_compile_count": "repro_torch.obs",
    "layout": "repro_torch.core.forceatlas2",
    "render": "repro_torch.render",
    "render_arrays": "repro_torch.render",
    "stream_pipeline": "repro_torch.core.stream",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute '{name}'")


def __dir__():
    return sorted(set(globals()) | set(__all__))
