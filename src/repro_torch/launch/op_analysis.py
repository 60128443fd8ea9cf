"""What one step does on one rank, counted as it runs: the port's
counterpart of the reference's ``launch/hlo_analysis.py``.

The reference reads the partitioned HLO text of a compiled step (all
shapes per device) and counts its dots' FLOPs and HBM traffic and its
collectives' payloads. The port has no compiled module: it runs the step
eagerly, one rank of the mesh, usually on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``, the dry run's), and
``OpCounter``, a ``TorchDispatchMode``, sees every ATen op it issues:

* the products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``):
  ``dot_flops`` += 2·prod(out)·prod(contracted dims) and
  ``dot_traffic_bytes`` += bytes(lhs) + bytes(rhs) + bytes(out), the
  reference's formulas (``hlo_analysis.py:105-133``); ``n_dots`` counts
  them;
* the collectives (the ``c10d`` ops ``allreduce_``, ``allgather_``,
  ``_allgather_base_``, ``reduce_scatter_``, ``_reduce_scatter_base_``,
  ``alltoall_``, ``broadcast_``): payload = the bytes of the op's result
  (the gathered tensor of an all-gather) × the reference's ring factor
  over the size k of the op's process group — 2(k−1)/k for an all-reduce,
  (k−1)/k for an all-gather or reduce-scatter, 1 otherwise —, summed in
  ``collective_bytes`` and by kind in ``collective_counts`` (payload bytes,
  as the reference's field holds); ``collective_calls`` counts the calls;
* the kernel entries' abstract rules (``kernels/build.py``): calls,
  operations and bytes of each entry, in ``kernels``;
* live bytes: a storage counts from the op that creates it until its last
  tensor is freed (a ``weakref`` finalizer on every tensor an op returns):
  ``peak_bytes`` is the most live at once, the step's inputs included.

Everything is per rank, as the reference's numbers are per device. The
reference's ``n_whiles`` (while loops and their trip counts) has no
eager meaning: a loop runs its body every time, and every trip is counted
as it runs. Ops the step issues outside the counter's ``with`` block (its
inputs, made before) count only as inputs (``track_inputs``).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# Collective kinds by ``c10d`` op name, the reference's names.
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute", "recv_": "collective-permute",
}
_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
         aten.mv.default, aten.dot.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _storage_key(t: torch.Tensor):
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return None, 0
    return s._cdata, s.nbytes()


@dataclass
class OpStats:
    """``HLOStats``' fields (``n_whiles`` aside), per rank, and the kernel
    rules' and live bytes' counts."""

    dot_flops: float = 0.0
    dot_traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = field(default_factory=dict)  # kind → payload bytes
    collective_calls: dict = field(default_factory=dict)  # kind → calls
    n_dots: int = 0
    kernels: dict = field(default_factory=dict)  # entry → {calls, operations, bytes}
    input_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` keys: arguments, outputs,
        outputs aliasing arguments, and as temporaries what the peak holds
        beyond the arguments and the outputs of their own, so that
        arguments + outputs + temporaries − aliases is the peak (no code is
        generated: 0)."""
        own_out = self.output_bytes - self.alias_bytes
        return {
            "generated_code_size_in_bytes": 0,
            "argument_size_in_bytes": self.input_bytes,
            "output_size_in_bytes": self.output_bytes,
            "alias_size_in_bytes": self.alias_bytes,
            "temp_size_in_bytes": max(0, self.peak_bytes - self.input_bytes - own_out),
        }

    def kernel_totals(self) -> tuple[int, int]:
        """(operations, bytes) of every kernel rule call."""
        return (sum(k["operations"] for k in self.kernels.values()),
                sum(k["bytes"] for k in self.kernels.values()))


class OpCounter(TorchDispatchMode):
    """Count one rank's products, collectives, kernel rules and live bytes
    into ``stats`` (an ``OpStats``) while active. Enter it inside the fake
    mode (``with fake_mode, OpCounter() as c``) so that it sees each op
    before the fake mode runs it; it works on real tensors as well."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._live: dict = {}  # storage key → [nbytes, tensors alive]
        self._now = 0
        self._inputs: set = set()

    # ----------------------------------------------------------- live bytes
    def _release(self, key) -> None:
        slot = self._live.get(key)
        if slot is None:
            return
        slot[1] -= 1
        if slot[1] == 0:
            self._now -= slot[0]
            del self._live[key]

    def _hold(self, t: torch.Tensor) -> None:
        key, nbytes = _storage_key(t)
        if key is None:
            return
        slot = self._live.get(key)
        if slot is None:
            slot = self._live[key] = [nbytes, 0]
            self._now += nbytes
            self.stats.peak_bytes = max(self.stats.peak_bytes, self._now)
        slot[1] += 1
        weakref.finalize(t, self._release, key)

    def track_inputs(self, tree) -> None:
        """Count the step's inputs as live (and as its arguments)."""
        for t in _tensors(tree):
            key, nbytes = _storage_key(t)
            if key is not None and key not in self._inputs:
                self._inputs.add(key)
                self.stats.input_bytes += nbytes
            self._hold(t)

    def track_outputs(self, tree) -> None:
        """Count the step's outputs, and those that alias an input."""
        seen = set()
        for t in _tensors(tree):
            key, nbytes = _storage_key(t)
            if key is None or key in seen:
                continue
            seen.add(key)
            self.stats.output_bytes += nbytes
            if key in self._inputs:
                self.stats.alias_bytes += nbytes

    # ------------------------------------------------------------- kernels
    def _rule(self, entry: str, operations: int, nbytes: int) -> None:
        k = self.stats.kernels.setdefault(entry, {"calls": 0, "operations": 0, "bytes": 0})
        k["calls"] += 1
        k["operations"] += operations
        k["bytes"] += nbytes

    def __enter__(self):
        from repro_torch.kernels import build

        build.RULE_OBSERVERS.append(self._rule)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import build

        build.RULE_OBSERVERS.remove(self._rule)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ dispatch
    def _dot(self, func, args, out) -> None:
        if func in (aten.addmm.default, aten.baddbmm.default):
            lhs, rhs = args[1], args[2]
        else:
            lhs, rhs = args[0], args[1]
        contract = lhs.shape[-1] if lhs.dim() else 1
        s = self.stats
        s.dot_flops += 2.0 * out.numel() * max(contract, 1)
        s.dot_traffic_bytes += _nbytes(lhs) + _nbytes(rhs) + _nbytes(out)
        s.n_dots += 1

    def _collective(self, func, kind: str, args, kwargs, out) -> None:
        import torch.distributed as dist

        names = [a.name for a in func._schema.arguments]
        given = dict(zip(names, args), **kwargs)
        group = given.get("process_group")
        k = dist.ProcessGroup.unbox(group).size() if group is not None else 1
        result = out[0] if isinstance(out, (list, tuple)) and out else out
        nbytes = sum(_nbytes(t) for t in _tensors(result))
        if kind == "all-reduce":
            factor = 2.0 * (k - 1) / max(k, 1)
        elif kind in ("all-gather", "reduce-scatter"):
            factor = (k - 1) / max(k, 1)
        else:
            factor = 1.0
        s = self.stats
        s.collective_bytes += nbytes * factor
        s.collective_counts[kind] = s.collective_counts.get(kind, 0.0) + nbytes * factor
        s.collective_calls[kind] = s.collective_calls.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _DOTS:
            self._dot(func, args, out)
        elif func.namespace == "c10d":
            kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
            if kind is not None:
                self._collective(func, kind, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out
