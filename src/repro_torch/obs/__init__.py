"""Tracing, metrics and meters: nested wall-clock spans exported as Chrome
trace-event JSON (``trace``), process-global counters, gauges and
histograms (``metrics``), the port's own copies of the reference package's
modules with the same span and metric names; the device meters
(``meters``: the kernel-build counter behind ``jit_compile_count``, CUDA
memory gauges, ``torch.profiler`` traces); and the launchers' shared
``--trace-out``/``--metrics-out``/``--profile`` flags (``cli``)."""
from repro_torch.obs.cli import add_obs_args, obs_session
from repro_torch.obs.meters import (
    jit_compile_count,
    profile_trace,
    update_memory_gauges,
)
from repro_torch.obs.metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    Span,
    Tracer,
    enable_tracing,
    get_tracer,
    set_tracer,
)

__all__ = sorted([
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "NULL_TRACER", "Span", "Tracer", "counter", "gauge", "histogram",
    "enable_tracing", "get_tracer", "set_tracer", "add_obs_args",
    "obs_session", "jit_compile_count", "profile_trace",
    "update_memory_gauges",
])
