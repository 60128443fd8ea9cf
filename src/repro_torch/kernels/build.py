"""Build, load and call the port's hand-written CUDA kernels.

Route: every source ``src/repro_torch/csrc/<name>.cu`` exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library, which
is loaded with ``ctypes`` (pointers and the stream are ``c_void_p``). No
PyTorch header is compiled, so a build takes seconds, not minutes.

The build happens at first use, from the sources in the checkout only, into
``build/repro_torch_kernels/`` at the repository root. A library's file name
carries a hash of its source and flags, so an edited source rebuilds and an
unchanged one is reused. ``build()`` starts one ``nvcc`` per missing source,
all at once, and waits for all of them. Each ``nvcc`` build and each library
load adds one to ``cuda.kernel_builds`` (``obs.meters.jit_compile_count``);
a reuse adds nothing.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; ``check`` raises on a non-zero code, so
a refused launch never passes silently.

Every wrapper picks its form with ``route``: the kernel for a CUDA tensor,
the plain PyTorch version for a CPU tensor, and for a fake tensor
(``torch._subclasses.fake_tensor``, the dry run's), whatever device it
names, the entry's *abstract rule*: the wrapper's own allocations (output
and scratch, so their shapes, dtypes, strides and bytes are the kernel's)
with the launch left out, and the launch's operations and bytes handed to
``rule``, which tells every observer in ``RULE_OBSERVERS``. A rule is not
a launch: ``LAUNCHES`` counts the card's launches only. ``on_card``
is the same test for callers that pick between a kernel's form and a
plain one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.obs.meters import count_build

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("merge_scatter", "repulsion_nbody", "count_scatter", "disk_accum",
           "far_field", "near_field", "segment_sum", "cms_update")
# Launches per kernel entry in this process: each wrapper adds one where it
# launches its kernel, and nowhere else (a run reads them to show which
# kernels its path went through; set them to 0 before the run). A library's
# first entry is counted under the library's name; its other entries apart:
# K1's generic scatter_combine (merge_scatter), K2's and K6's row-range
# entries repulsion_rows and near_field_rows (repulsion_nbody, near_field),
# K3's small-disk entry count_disks (count_scatter), K7's layout entries
# (segment_sum; "segment_sum" counts the cell statistics): the layout
# build segment_offsets, the per-edge sum segment_sum_edges, the GNN
# gathers' gradients segment_sum_gather_bwd and FA2's fused attraction
# attraction_sum, and K8's keys-in entry cms_update_keys (cms_update;
# "cms_update" counts the hashed entry).
LAUNCHES = dict.fromkeys(
    KERNELS + ("scatter_combine", "repulsion_rows", "near_field_rows", "count_disks",
               "segment_offsets", "segment_sum_edges", "segment_sum_gather_bwd",
               "attraction_sum", "cms_update_keys"), 0)
# Callables ``observer(entry, operations, nbytes)`` told of each abstract
# rule call (the dry run's analysis registers one).
RULE_OBSERVERS: list = []
# The H100 SXM's SM count: a rule sizes K2's scratch with it where no card
# is present to ask.
H100_SMS = 132
# The floating types a layout's kernels (K2's entries, K7's attraction)
# take, by the code their C entries read.
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # nvcc wall time (0 when the library was already built)
    log: str  # nvcc/ptxas output: registers, shared memory, spills


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "repro_torch: nvcc not found (set CUDA_HOME or put nvcc on PATH); "
        "the CUDA kernels are built from src/repro_torch/csrc at first use"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names=KERNELS) -> dict:
    """Compile every named kernel not built yet, one ``nvcc`` each, all
    started together. Returns ``{name: BuildResult}``; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results, running = {}, {}
    for name in names:
        out = _target(name)
        if out.exists():
            results[name] = BuildResult(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        count_build()
        results[name] = BuildResult(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("repro_torch kernel build failed:\n" + "\n".join(failed))
    return results


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel (built on first call)."""
    lib = ctypes.CDLL(str(build((name,))[name].path))
    count_build()
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def entry(name: str, argtypes: list, symbol: str | None = None):
    """The C entry point ``symbol`` (default ``name``) of library ``name``,
    typed."""
    fn = getattr(library(name), symbol or name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code} ({msg})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device,
            shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def is_fake(t) -> bool:
    """True for a fake tensor (``FakeTensorMode``), whatever device it names."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def on_card(t) -> bool:
    """A CUDA tensor, or a fake one: the path a kernel runs on (a dry run
    traces the card's path on fake tensors of either device)."""
    return t.device.type == "cuda" or is_fake(t)


def route(t, what: str) -> str:
    """The form of a kernel entry for input ``t``: "rule" for a fake tensor
    (whatever its device), "plain" for a CPU tensor, "cuda" for a CUDA
    tensor; raises on any other device."""
    if is_fake(t):
        return "rule"
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"{what}: unsupported device {t.device}")


def rule(entry: str, out, operations: int, nbytes: int):
    """Tell every observer of one abstract rule call of ``entry`` (its
    launch's operations and bytes) and return ``out``."""
    for observe in RULE_OBSERVERS:
        observe(entry, int(operations), int(nbytes))
    return out


def sm_count(device: torch.device) -> int:
    """The SM count of ``device``'s card; ``H100_SMS`` where no card is
    present (a dry run on the CPU)."""
    if device.type != "cuda" or not torch.cuda.is_available():
        return H100_SMS
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
