"""The port's meters and CLI plumbing (``repro_torch.obs.meters``,
``repro_torch.obs.cli``) on the CPU: the build counter behind
``jit_compile_count`` counts each ``nvcc`` build and each library load
once and a reuse never, the memory gauges are absent without CUDA,
``profile_trace`` writes a Chrome trace or raises, and ``obs_session``
writes the trace and metrics files."""
import argparse
import json
import os
import stat
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import cli, meters  # noqa: E402
from repro_torch.obs.metrics import REGISTRY  # noqa: E402
from repro_torch.obs.trace import get_tracer, set_tracer  # noqa: E402

_FAKE_NVCC = """#!/bin/sh
# Writes an empty file at the path after -o, as a build would.
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` under ``CUDA_HOME`` and a build directory of
    the test's own."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.library.cache_clear()
    yield
    build.library.cache_clear()


def test_build_counter_counts_builds_and_loads_once(fake_toolchain, monkeypatch):
    c0 = meters.jit_compile_count()
    out = build.build(("cms_update", "segment_sum"))
    assert set(out) == {"cms_update", "segment_sum"} and all(r.path.exists() for r in out.values())
    assert meters.jit_compile_count() == c0 + 2  # one per nvcc build
    again = build.build(("cms_update", "segment_sum"))
    assert all(r.seconds == 0.0 for r in again.values())
    assert meters.jit_compile_count() == c0 + 2  # reused from the build cache
    loads = []

    def fake_cdll(path):
        loads.append(path)
        return types.SimpleNamespace(cms_update_error_string=types.SimpleNamespace())

    monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
    lib = build.library("cms_update")
    assert build.library("cms_update") is lib and len(loads) == 1
    assert meters.jit_compile_count() == c0 + 3  # one load, then the loaded set


def test_build_counter_registration_is_idempotent():
    first = REGISTRY.counter(meters.BUILDS)
    n = meters.jit_compile_count()
    assert meters.jit_compile_count() == n
    assert REGISTRY.counter(meters.BUILDS) is first
    meters.count_build()
    assert meters.jit_compile_count() == n + 1 and REGISTRY.counter(meters.BUILDS) is first


def test_memory_gauges_absent_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = set(REGISTRY.names("cuda.live"))
    assert meters.update_memory_gauges() == {}
    assert set(REGISTRY.names("cuda.live")) == before
    assert not REGISTRY.names("cuda.dev")


def test_profile_trace_none_is_a_plain_block(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def broken(**_):
        raise AssertionError("the profiler must not start")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with meters.profile_trace(None):
        x = torch.ones(3).sum()
    with meters.profile_trace(""):
        x = x + 1
    assert float(x) == 4.0 and os.listdir(tmp_path) == []


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "prof"
    with meters.profile_trace(str(out)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    trace = json.loads((out / meters.PROFILE_FILE).read_text())
    assert trace["traceEvents"]


def test_profile_trace_error_raises(tmp_path, monkeypatch):
    def failing(**_):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", failing)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with meters.profile_trace(str(tmp_path / "prof")):
            pass
    assert not (tmp_path / "prof" / meters.PROFILE_FILE).exists()


def _args(tmp_path, **kw):
    ap = argparse.ArgumentParser()
    cli.add_obs_args(ap)
    argv = []
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return ap.parse_args(argv)


def test_obs_session_writes_trace_and_metrics(tmp_path):
    saved = get_tracer()
    try:
        args = _args(tmp_path, trace_out=tmp_path / "t.json", trace_jsonl=True,
                     metrics_out=tmp_path / "m.txt", profile=tmp_path / "prof")
        with cli.obs_session(args) as tr:
            with tr.span("unit.work", k=1):
                torch.arange(10).sum()
        trace = json.loads((tmp_path / "t.json").read_text())
        names = [e["name"] for e in trace["traceEvents"]]
        assert "unit.work" in names
        assert (tmp_path / "t.json.jsonl").read_text().strip()
        dump = (tmp_path / "m.txt").read_text()
        assert f"{meters.BUILDS} " in dump
        assert (tmp_path / "prof" / meters.PROFILE_FILE).exists()
    finally:
        set_tracer(saved)


def test_obs_session_without_flags_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with cli.obs_session(_args(tmp_path)) as tr:
        assert tr is get_tracer()
    assert os.listdir(tmp_path) == []
