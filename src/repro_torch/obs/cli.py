"""Shared CLI plumbing: every ``repro_torch.launch`` launcher grows the same
observability flags through ``add_obs_args`` + ``obs_session``::

    add_obs_args(parser)
    ...
    with obs_session(args):
        <launcher body>

* ``--trace-out PATH``  — enable the process-global tracer for the run and
  write the Chrome trace-event (Perfetto-loadable) span file at exit
  (``PATH.jsonl`` beside it with ``--trace-jsonl``).
* ``--metrics-out PATH`` — write the plain-text metrics dump at exit, after
  refreshing the CUDA memory gauges and the build counter.
* ``--profile DIR``     — a ``torch.profiler`` trace of the whole run,
  written to ``DIR/trace.json``; a profiler error fails the run.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.meters import (
    PROFILE_FILE,
    jit_compile_count,
    profile_trace,
    update_memory_gauges,
)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import enable_tracing, get_tracer


def add_obs_args(ap) -> None:
    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--trace-out", default="",
                   help="write a Chrome-trace/Perfetto span file of the run")
    g.add_argument("--trace-jsonl", action="store_true",
                   help="also write <trace-out>.jsonl (one span per line)")
    g.add_argument("--metrics-out", default="",
                   help="write the plain-text metrics registry dump")
    g.add_argument("--profile", default="",
                   help=f"write a torch.profiler trace to DIR/{PROFILE_FILE}")


@contextlib.contextmanager
def obs_session(args):
    """Run the enclosed launcher body under the requested instrumentation
    and write the artifacts on the way out. Yields the active tracer."""
    if args.trace_out or args.metrics_out:
        jit_compile_count()  # the build counter shows in the dump, at 0 if unused
    tracer = enable_tracing() if args.trace_out else get_tracer()
    try:
        with profile_trace(args.profile or None):
            yield tracer
        if args.profile:
            print(f"obs: wrote torch.profiler trace {args.profile}/{PROFILE_FILE}")
    finally:
        if args.metrics_out or args.trace_out:
            update_memory_gauges()
        if args.trace_out:
            tracer.to_chrome(args.trace_out)
            print(f"obs: wrote {args.trace_out} "
                  f"({len(tracer.spans())} spans)")
            if args.trace_jsonl:
                print(f"obs: wrote {tracer.to_jsonl(args.trace_out + '.jsonl')}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(REGISTRY.dump_text() + "\n")
            print(f"obs: wrote {args.metrics_out} "
                  f"({len(REGISTRY.names())} metrics)")
