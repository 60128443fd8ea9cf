"""Device-facing meters: kernel builds, CUDA memory, ``torch.profiler``
traces.

* ``jit_compile_count`` — monotone count of the kernel libraries this
  process compiled or loaded (counter ``cuda.kernel_builds``). The port
  compiles nothing through a tracing JIT: what it compiles is the
  ``nvcc`` build of a ``csrc/*.cu`` source and the ``ctypes`` load of its
  library (``repro_torch.kernels.build``). Each counts one; a library
  reused from the build cache or from the loaded set counts nothing. A
  ``torch.compile`` or CUDA-graph capture added to the port must count
  here too (``count_build``). The name is the reference package's, for
  the same public surface.
* ``update_memory_gauges`` — CUDA allocator bytes per device into
  ``cuda.live_bytes``, ``cuda.live_bytes_peak`` and
  ``cuda.dev<i>.peak_bytes``. On a host without CUDA the gauges are
  absent.
* ``profile_trace`` — a ``torch.profiler`` trace of the enclosed block,
  exported as a Chrome trace into a directory (``--profile DIR``). A
  profiler error raises: a run that asked for a profile never reports one
  it did not write.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.obs.metrics import REGISTRY

BUILDS = "cuda.kernel_builds"
PROFILE_FILE = "trace.json"


def count_build(registry=None) -> None:
    """Add one compile (an ``nvcc`` build, a library load, a capture)."""
    reg = registry if registry is not None else REGISTRY
    reg.counter(BUILDS).inc()


def jit_compile_count() -> int:
    """Monotone count of kernel builds and library loads in this process
    (``cuda.kernel_builds``): callers take deltas. A service in steady
    state builds nothing, so its delta across a served trace is 0."""
    return int(REGISTRY.counter(BUILDS).value)


def update_memory_gauges(registry=None) -> dict:
    """Refresh the CUDA memory gauges and return their snapshot:

    * ``cuda.live_bytes`` — bytes the caching allocator holds for tensors
      now, summed over the devices, and its high-watermark
      ``cuda.live_bytes_peak``;
    * ``cuda.dev<i>.peak_bytes`` — ``torch.cuda.max_memory_allocated(i)``.

    Empty on a host without CUDA. A device this process never used reads
    0 without being initialised."""
    reg = registry if registry is not None else REGISTRY
    if not torch.cuda.is_available():
        return {}
    live = 0
    out = {}
    for i in range(torch.cuda.device_count()):
        live += torch.cuda.memory_allocated(i)
        peak = torch.cuda.max_memory_allocated(i)
        name = f"cuda.dev{i}.peak_bytes"
        reg.gauge(name).set_max(peak)
        out[name] = peak
    reg.gauge("cuda.live_bytes").set(live)
    reg.gauge("cuda.live_bytes_peak").set_max(live)
    out["cuda.live_bytes"] = live
    return out


@contextlib.contextmanager
def profile_trace(out_dir: str | None):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    where a card is present) and write ``<out_dir>/trace.json``, a Chrome
    trace (Perfetto loads it). ``None`` or ``""`` is a plain block. Any
    profiler error propagates."""
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's queued work, in the trace
    prof.export_chrome_trace(os.path.join(out_dir, PROFILE_FILE))
