"""A unit of work under ``torch.profiler`` with the card's activity alone,
reduced in memory to what the per-layer metrics read: device time and
launch count by kernel name, the device's busy seconds (the union of its
activity) within the traced window, and the idle time between device
activity, summed by the device operation the card waited for.

Host operations are not recorded: at tens of microseconds an operation
the profiler would turn a host-paced unit's launches into seconds of idle
device. So an idle gap is named by the operation that ended it, not by
what the host was doing meanwhile."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class DeviceTrace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name → [launches, seconds]
    idle_before: dict = field(default_factory=dict)  # device op → idle seconds before it

    def kernel(self, *symbols: str) -> tuple[int, float]:
        """(launches, seconds) of the device activity whose name holds one
        of ``symbols``; launches count the first symbol's events."""
        n, s = 0, 0.0
        for name, (k, sec) in self.kernels.items():
            if any(sym in name for sym in symbols):
                s += sec
                if symbols[0] in name:
                    n += k
        return n, s

    def top_kernels(self, k: int = 10) -> list:
        """[[name, seconds]] of the ``k`` kernels that took the most time."""
        return top([(name, sec) for name, (_, sec) in self.kernels.items()], k)

    def top_idle(self, k: int = 10) -> list:
        """[["before <device op>", seconds]] of the ``k`` largest idle sums."""
        return top([(f"before {name}", sec) for name, sec in self.idle_before.items()], k)


def top(rows: list, k: int) -> list:
    return [[name, sec] for name, sec in sorted(rows, key=lambda r: -r[1])[:k]]


def traced(fn):
    """Run ``fn()`` under the profiler → (its result, DeviceTrace)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        out = fn()
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    return out, reduce(prof.profiler.kineto_results.events(), (t1 - t0) * 1e-9)


def reduce(events, window_s: float) -> DeviceTrace:
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    start, end, names = [], [], []
    for e in events:
        if e.device_type() == cuda:
            t = e.start_ns()
            start.append(t)
            end.append(t + e.duration_ns())
            names.append(e.name())
    out = DeviceTrace(window_s=window_s)
    if not start:
        return out
    s = np.asarray(start, np.int64)
    t = np.asarray(end, np.int64)
    kinds, inverse = np.unique(np.asarray(names, dtype=object), return_inverse=True)
    launches = np.bincount(inverse, minlength=len(kinds))
    seconds = np.bincount(inverse, weights=(t - s) * 1e-9, minlength=len(kinds))
    out.kernels = {str(k): [int(n), float(sec)] for k, n, sec in zip(kinds, launches, seconds)}
    order = np.argsort(s, kind="stable")
    s, t, inverse = s[order], t[order], inverse[order]
    reach = np.maximum.accumulate(t)
    gap = s[1:] - reach[:-1]
    is_gap = gap > 0
    # idle at the window's ends counts as idle, not busy
    out.busy_s = (int(t.max() - s.min()) - int(gap[is_gap].sum())) * 1e-9
    idle = np.bincount(inverse[1:][is_gap], weights=gap[is_gap] * 1e-9,
                       minlength=len(kinds))
    out.idle_before = {str(kinds[i]): float(idle[i]) for i in np.flatnonzero(idle)}
    return out
