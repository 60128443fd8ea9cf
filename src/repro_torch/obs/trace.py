"""Nested wall-clock span tracing — the repo's one timing instrument.

A ``Tracer`` hands out context-manager spans::

    with tracer.span("detect.chunk", chunk=i):
        ...

Spans nest through a **thread-local** stack, so concurrent callers (the
serve engine's tick loop, the prefetch ring's staging fills) each build
their own correctly-parented tree while completed spans land in one
shared, locked list. Timestamps are ``time.perf_counter`` relative to the
tracer's construction, so every span of a process shares one clock.

Everything here is host-side: a span brackets the *launch* of device
work, not its execution (CUDA launches are asynchronous). Stages that must
attribute device time synchronize inside their span — the tracer never
adds synchronization of its own.

Disabled tracers (``Tracer(enabled=False)``, the module's ``NULL_TRACER``,
and the process-global default before ``enable_tracing()``) return a
shared no-op span: one attribute check + one call per ``span()``, no
allocation, no lock.

Exports: Chrome trace-event JSON (``to_chrome`` — loadable by Perfetto /
``chrome://tracing``), JSON-lines (``to_jsonl``), and an indented text
tree (``format_tree``) for terminals and docs.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    """One completed span. ``t0``/``t1`` are seconds on the tracer's
    clock (0 = tracer construction); ``parent`` is the enclosing span's
    ``span_id`` or None for a root; ``tid`` is the OS thread ident."""

    name: str
    t0: float
    t1: float
    span_id: int
    parent: int | None = None
    tid: int = 0
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op span for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _SpanHandle:
    """Live (open) span: context manager pushed on the thread's stack."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent = None
        self.t0 = 0.0

    def set(self, **attrs):
        """Attach/overwrite attributes on the open span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self._tracer._stack()
        if stack:
            self.parent = stack[-1].span_id
        stack.append(self)
        self.t0 = self._tracer._now()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._now()
        stack = self._tracer._stack()
        # Tolerate out-of-order exits (a caller leaking a span) by popping
        # back to this handle instead of corrupting deeper frames.
        while stack and stack[-1] is not self:
            stack.pop()
        if stack:
            stack.pop()
        self._tracer._record(
            Span(
                name=self.name,
                t0=self.t0,
                t1=t1,
                span_id=self.span_id,
                parent=self.parent,
                tid=threading.get_ident(),
                attrs=self.attrs,
            )
        )
        return False


class Tracer:
    """Thread-safe collector of nested wall-clock spans."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._epoch = time.perf_counter()
        self._ids = itertools.count(1)  # thread-safe in CPython
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._local = threading.local()

    # -- recording ----------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def span(self, name: str, **attrs):
        """Open a nested span; use as ``with tracer.span("phase"):``."""
        if not self.enabled:
            return NULL_SPAN
        return _SpanHandle(self, name, attrs)

    # -- inspection ---------------------------------------------------------

    def spans(self) -> list[Span]:
        """Snapshot of completed spans, in completion order."""
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def span_names(self) -> set[str]:
        return {s.name for s in self.spans()}

    def children(self, span_id: int | None) -> list[Span]:
        """Completed spans whose parent is ``span_id`` (None = roots),
        ordered by start time."""
        return sorted(
            (s for s in self.spans() if s.parent == span_id),
            key=lambda s: s.t0,
        )

    # -- exporters ----------------------------------------------------------

    def to_chrome(self, path: str) -> str:
        """Write the Chrome trace-event (Perfetto-loadable) ``.trace.json``:
        one complete ("ph": "X") event per span, µs timestamps, span
        attributes under "args". Returns ``path``."""
        pid = os.getpid()
        events = [
            {
                "name": s.name,
                "ph": "X",
                "ts": s.t0 * 1e6,
                "dur": max(s.duration, 0.0) * 1e6,
                "pid": pid,
                "tid": s.tid,
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            }
            for s in self.spans()
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path

    def to_jsonl(self, path: str) -> str:
        """Write one JSON object per span (name, t0, t1, duration, span_id,
        parent, tid, attrs) — the grep/pandas-friendly log form."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(
                    json.dumps(
                        {
                            "name": s.name,
                            "t0": s.t0,
                            "t1": s.t1,
                            "duration": s.duration,
                            "span_id": s.span_id,
                            "parent": s.parent,
                            "tid": s.tid,
                            "attrs": {
                                k: _jsonable(v) for k, v in s.attrs.items()
                            },
                        }
                    )
                    + "\n"
                )
        return path

    def format_tree(self, max_children: int = 8) -> str:
        """Indented text rendering of the span forest (first
        ``max_children`` children per span, a summary line for the rest)."""
        lines: list[str] = []

        def walk(span: Span, depth: int) -> None:
            lines.append(
                f"{'  ' * depth}{span.name:<24} {span.duration * 1e3:9.2f} ms"
            )
            kids = self.children(span.span_id)
            for kid in kids[:max_children]:
                walk(kid, depth + 1)
            if len(kids) > max_children:
                rest = kids[max_children:]
                total = sum(k.duration for k in rest)
                lines.append(
                    f"{'  ' * (depth + 1)}… {len(rest)} more "
                    f"{total * 1e3:9.2f} ms"
                )

        for root in self.children(None):
            walk(root, 0)
        return "\n".join(lines)


def _jsonable(v):
    """Span attribute → JSON-safe scalar (numpy ints, tile specs, …)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        try:
            return float(v)
        except (TypeError, ValueError):
            return repr(v)


NULL_TRACER = Tracer(enabled=False)

# Process-global default: subsystems fall back to this when no tracer was
# threaded through their config, so a CLI flag can light up the whole
# pipeline without touching call signatures. Disabled until
# ``enable_tracing()``.
_GLOBAL = NULL_TRACER


def get_tracer() -> Tracer:
    """The process-global tracer (disabled no-op until enabled)."""
    return _GLOBAL


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install ``tracer`` as the process-global default (None resets to
    the disabled NULL_TRACER). Returns the installed tracer."""
    global _GLOBAL
    _GLOBAL = tracer if tracer is not None else NULL_TRACER
    return _GLOBAL


def enable_tracing() -> Tracer:
    """Install (and return) a fresh enabled process-global tracer — the
    ``--trace-out`` CLI entry point."""
    return set_tracer(Tracer(enabled=True))
