"""Process-global metrics: named counters, gauges, and log-bucket
histograms — the single sink the scattered per-subsystem stats dataclasses
(``StreamStats``, ``RenderStats``, ``BGVResult.timings``, the tile cache
accounting) publish into, and the single source exporters read from.

Zero dependencies and no numpy on the hot path: a histogram is a fixed
array of power-of-two buckets indexed by ``math.frexp`` — O(1) record,
O(buckets) quantile — so per-request serving code can record latencies
without touching the device or allocating.

``REGISTRY`` is the process-global instance (module helpers ``counter`` /
``gauge`` / ``histogram`` resolve against it). Metric names are
dot-namespaced by subsystem: ``stream.*``, ``layout.*``, ``render.*``,
``serve.*`` — the glossary lives in README "Observability".
"""
from __future__ import annotations

import json
import math
import threading

# Histogram bucket i covers [2^(i + _EXP_LO - 1), 2^(i + _EXP_LO)).
# Exponent range [-40, 40] spans ~1e-12 .. 1e12 — nanoseconds to
# terabytes — with out-of-range values clamped to the end buckets.
_EXP_LO = -40
_EXP_HI = 40
_N_BUCKETS = _EXP_HI - _EXP_LO + 1


class Counter:
    """Monotone counter. ``inc`` is the only mutator."""

    kind = "counter"

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, v: int = 1) -> None:
        with self._lock:
            self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-value gauge with ``set`` / ``set_max`` (high-watermark)."""

    kind = "gauge"

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        with self._lock:
            if v > self.value:
                self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed log2-bucket histogram of positive values.

    ``record`` maps a value to its power-of-two bucket via ``math.frexp``
    (no numpy, no allocation); non-positive values land in a dedicated
    underflow count so latency code never has to pre-filter. Quantiles
    interpolate linearly inside the covering bucket — worst-case relative
    error is the bucket width (2×), plenty for p50/p99 dashboards.
    """

    kind = "histogram"

    __slots__ = ("name", "buckets", "count", "total", "vmin", "vmax",
                 "underflow", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.buckets = [0] * _N_BUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.underflow = 0  # values <= 0
        self._lock = threading.Lock()

    @staticmethod
    def bucket_index(v: float) -> int:
        _, e = math.frexp(v)  # v = m * 2^e, m in [0.5, 1)
        return min(max(e - _EXP_LO, 0), _N_BUCKETS - 1)

    @staticmethod
    def bucket_bounds(i: int) -> tuple[float, float]:
        e = i + _EXP_LO
        return (2.0 ** (e - 1), 2.0**e)

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if v <= 0.0 or v != v:  # non-positive or NaN
                self.underflow += 1
                return
            self.buckets[self.bucket_index(v)] += 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q ∈ [0, 1] → interpolated value; 0.0 with no samples."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if seen + c >= target:
                lo, hi = self.bucket_bounds(i)
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return lo
                frac = (target - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.vmax

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    def snapshot(self):
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.p50,
            "p99": self.p99,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "underflow": self.underflow,
        }


class MetricsRegistry:
    """Name → metric map with get-or-create accessors.

    Asking for an existing name with a different kind raises — one name,
    one schema, process-wide.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(name)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"not {cls.kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def get(self, name: str):
        """The metric registered under ``name`` or None."""
        return self._metrics.get(name)

    def value(self, name: str, default=0):
        """Scalar value of a counter/gauge (default when unregistered)."""
        m = self._metrics.get(name)
        return default if m is None else m.value

    def names(self, prefix: str = "") -> list[str]:
        return sorted(n for n in self._metrics if n.startswith(prefix))

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self, prefix: str = "") -> dict:
        """{name: scalar-or-histogram-dict} for every matching metric."""
        return {
            n: self._metrics[n].snapshot() for n in self.names(prefix)
        }

    def dump_text(self, prefix: str = "") -> str:
        """Plain-text dump, one ``name value`` line per metric (histograms
        expand to count/mean/p50/p99) — the ``--metrics-out`` /
        ``$GITHUB_STEP_SUMMARY`` format."""
        lines = []
        for n in self.names(prefix):
            m = self._metrics[n]
            if m.kind == "histogram":
                s = m.snapshot()
                lines.append(
                    f"{n} count={s['count']} mean={s['mean']:.6g} "
                    f"p50={s['p50']:.6g} p99={s['p99']:.6g}"
                )
            else:
                v = m.value
                lines.append(
                    f"{n} {v:.6g}" if isinstance(v, float) else f"{n} {v}"
                )
        return "\n".join(lines)

    def to_json(self, path: str, prefix: str = "") -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(prefix), f, indent=2)
        return path


REGISTRY = MetricsRegistry()

# The error/degradation counters: every recovery path in the codebase
# increments one of these at the point of occurrence, and they are
# pre-registered (``ensure_error_counters``) by the subsystems that can
# produce them — so ``dump_text``/``snapshot`` always show them at 0 instead
# of silently omitting "no errors", and CI can assert on their presence.
ERROR_COUNTERS = (
    "errors.io_retries",  # transient store reads retried (resilience.validate)
    "errors.quarantined_chunks",  # chunks replaced by trash padding
    "errors.invalid_edges",  # out-of-range/self-loop rows dropped to trash
    "errors.fa2_recoveries",  # non-finite FA2 iterations rolled back + damped
    "errors.failed_tiles",  # tile renders that returned an error tile
    "errors.shed_tiles",  # queued tile misses shed past the deadline
)


def ensure_error_counters(registry: MetricsRegistry | None = None) -> None:
    """Register every ``errors.*`` counter (at 0) so degradation is visible
    in metric dumps even when nothing has failed yet."""
    reg = registry if registry is not None else REGISTRY
    for name in ERROR_COUNTERS:
        reg.counter(name)


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)
