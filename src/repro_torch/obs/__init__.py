"""Tracing and metrics (stdlib only): nested wall-clock spans exported as
Chrome trace-event JSON (``trace``) and process-global counters, gauges and
histograms (``metrics``). The port's own copies of the reference package's
modules, with the same span and metric names."""
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
