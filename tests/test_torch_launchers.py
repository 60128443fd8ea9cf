"""The port's launchers (``repro_torch.launch``) and the edge-store CLI on
the CPU at a tiny size: each ``main([... "--device", "cpu"])`` writes its
image, span trace and metrics dump; ``load_edges`` equals the reference's;
the converter round-trips npy → bin → shards, readable by both packages;
``stream_runner`` streams equal to one shot, and a run killed at a chunk
boundary resumes to the same result; the port's examples
(``examples/*_torch.py``) run at a small size."""
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import edge_store as jstore  # noqa: E402
from repro.launch.layout import load_edges as jload_edges  # noqa: E402

from repro_torch.data import edge_store  # noqa: E402
from repro_torch.launch import layout, render_runner, serve, stream_runner  # noqa: E402
from repro_torch.resilience import KillSwitch, SimulatedPreemption, StreamCheckpointer  # noqa: E402
from repro_torch.obs.metrics import ERROR_COUNTERS, REGISTRY  # noqa: E402
from repro_torch.obs.trace import get_tracer, set_tracer  # noqa: E402
from repro_torch.render.png import read_png  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_tracer():
    saved = get_tracer()
    yield
    set_tracer(saved)


@pytest.fixture(autouse=True)
def _fresh_error_counters():
    """The metrics dumps read the process-global ``errors.*`` counters, which
    tests of other files run earlier in this process may have moved; each
    test here starts them at 0."""
    for name in ERROR_COUNTERS:
        REGISTRY.counter(name).value = 0


def _obs(tmp_path):
    return ["--trace-out", str(tmp_path / "trace.json"),
            "--metrics-out", str(tmp_path / "metrics.txt"), "--device", "cpu"]


def _check_obs(tmp_path, *spans):
    names = {e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert set(spans) <= names, names
    dump = (tmp_path / "metrics.txt").read_text()
    assert re.search(r"^cuda\.kernel_builds \d+$", dump, re.M), dump


def test_serve_launcher_writes_its_outputs(tmp_path, capsys):
    png = tmp_path / "tile.png"
    serve.main(["--nodes", "300", "--communities", "6", "--depth", "2", "--tile-size", "64",
                "--iterations", "5", "--requests", "60", "--drill-frac", "0.2",
                "--out", str(png), *_obs(tmp_path)])
    out = capsys.readouterr().out
    assert read_png(str(png)).shape == (64, 64, 3)
    assert "served 60 requests" in out and "steady-state kernel builds: 0" in out
    assert "0 failed tiles" in out
    _check_obs(tmp_path, "serve.warmup", "serve.render_tile", "serve.render_drill")
    dump = (tmp_path / "metrics.txt").read_text()
    assert "serve.cache_tiles 13" in dump and "errors.failed_tiles " in dump


@pytest.mark.parametrize("full", [False, True])
def test_render_runner_writes_its_outputs(tmp_path, capsys, full):
    png = tmp_path / "graph.png"
    render_runner.main(["--nodes", "400", "--communities", "8", "--width", "96",
                        "--height", "64", "--iterations", "4", "--chunk", "256",
                        "--out", str(png), *_obs(tmp_path)] + (["--full"] if full else []))
    out = capsys.readouterr().out
    assert read_png(str(png)).shape == (64, 96, 3)
    assert "throughput:" in out and "peak device bytes (render)" in out
    _check_obs(tmp_path, "render.nodes", "render.edges")
    assert "render.seconds" in (tmp_path / "metrics.txt").read_text()


def test_layout_launcher_writes_its_outputs(tmp_path):
    svg = tmp_path / "g.svg"
    layout.main(["--edges", "synthetic:300:6", "--iterations", "5", "--init", "degree",
                 "--out", str(svg), *_obs(tmp_path)])
    assert svg.read_text().startswith("<svg")
    rows = (tmp_path / "g.csv").read_text().splitlines()
    assert rows[0] == "community,size,x,y,color_group" and len(rows) > 2
    _check_obs(tmp_path, "biggraphvis", "layout")


def _csv_rows(path):
    rows = [r.split(",") for r in path.read_text().splitlines()[1:]]
    return (np.array([[int(r[0]), int(r[1]), int(r[4])] for r in rows]),
            np.array([[float(r[2]), float(r[3])] for r in rows]))


def test_layout_launcher_default_init_matches_reference(tmp_path, monkeypatch):
    """With no ``--init`` both launchers start from the same draw: the
    CSV's communities, sizes and groups are equal, its positions within
    1e-4·max|pos| (test_torch_pipeline.py) plus the CSV's 0.005 rounding."""
    from repro.launch import layout as jlayout

    args = ["--edges", "synthetic:300:6", "--iterations", "5"]
    layout.main(args + ["--out", str(tmp_path / "g.svg"), "--device", "cpu"])
    monkeypatch.setattr("sys.argv", ["layout"] + args + ["--out", str(tmp_path / "r.svg")])
    jlayout.main()
    got_ids, got_pos = _csv_rows(tmp_path / "g.csv")
    want_ids, want_pos = _csv_rows(tmp_path / "r.csv")
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_pos, want_pos, rtol=0,
                               atol=1e-4 * np.abs(want_pos).max() + 0.01)


def test_load_edges_matches_reference(tmp_path):
    for spec in ("synthetic:200:4",):
        got, n = layout.load_edges(spec)
        want, jn = jload_edges(spec)
        assert n == jn == 200
        np.testing.assert_array_equal(got, want)
    p = tmp_path / "g.txt"
    p.write_text("# comment\n% other\n10 20\n20 30 7\n10 30\n40 10\n30 30\n\n")
    got, n = layout.load_edges(str(p))
    want, jn = jload_edges(str(p))
    assert n == jn == 4 and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_edge_store_cli_round_trips(tmp_path, capsys):
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 1000, (2501, 2)).astype(np.int32)
    npy = tmp_path / "e.npy"
    np.save(npy, edges)
    binp, shards, back = tmp_path / "e.bin", tmp_path / "shards", tmp_path / "back.npy"
    edge_store.main(["convert", str(npy), str(binp), "--chunk-rows", "700"])
    edge_store.main(["convert", str(binp), str(shards), "--format", "shards",
                     "--shard-edges", "1000"])
    edge_store.main(["convert", str(shards), str(back)])
    edge_store.main(["info", str(shards)])
    out = capsys.readouterr().out
    assert "wrote 3 shards" in out and "2501 edges (ShardedEdgeStore)" in out
    for path in (binp, shards, back):
        store = edge_store.open_edge_store(path)
        np.testing.assert_array_equal(store.read(0, store.n_edges), edges)
        jstore_ = jstore.open_edge_store(path)  # the reference reads them too
        np.testing.assert_array_equal(jstore_.read(0, jstore_.n_edges), edges)
    with pytest.raises(SystemExit):
        edge_store.main(["convert"])


_SMALL = ["--nodes", "600", "--communities", "6", "--chunk", "512", "--block-size", "128",
          "--iterations", "4", "--rounds", "2"]


@pytest.mark.parametrize("source", ["memory", "npy"])
def test_stream_runner_streams_equal_to_one_shot(tmp_path, capsys, source):
    stream_runner.main([*_SMALL, "--source", source, *_obs(tmp_path)])
    out = capsys.readouterr().out
    assert "streamed == one-shot: True" in out
    assert "passes=3" in out and "peak device bytes" in out
    _check_obs(tmp_path, "stream_pipeline", "detect", "supergraph")
    assert "errors.quarantined_chunks 0" in (tmp_path / "metrics.txt").read_text()


def test_stream_runner_resumes_after_a_kill(tmp_path, capsys):
    """A run killed through ``StreamRunner.run`` at a detect boundary, then
    ``--resume`` from the launcher, equals the one-shot run."""
    from dataclasses import replace

    from repro_torch.core.pipeline import biggraphvis, default_config
    from repro_torch.core.stream import StreamConfig
    from repro_torch.graph import mode_degree, planted_partition

    n = 600
    edges, _ = planted_partition(n, 6, 0.12, 2e-4, seed=5)
    cfg = default_config(n, len(edges), mode_degree(edges, n), rounds=2, iterations=4)
    cfg = replace(cfg, scoda=replace(cfg.scoda, block_size=128))
    runner = stream_runner.StreamRunner(
        cfg, stream_runner.StreamRunnerConfig(stream=StreamConfig(chunk_size=512)),
        device="cpu")
    ckdir = str(tmp_path / "ck")
    ck = StreamCheckpointer(ckdir, every_chunks=2, on_boundary=KillSwitch(5))
    with pytest.raises(SimulatedPreemption):
        runner.run(edges, n, checkpoint=ck)
    assert ck.saves == 3
    resumed = runner.run(edges, n, checkpoint=StreamCheckpointer(ckdir, every_chunks=2),
                         resume=True)
    want = biggraphvis(edges, n, cfg, device="cpu")
    assert resumed.stream.resumed_at == "detect:r0:c6"
    np.testing.assert_array_equal(resumed.labels, want.labels)
    np.testing.assert_array_equal(resumed.sizes, want.sizes)
    stream_runner.main([*_SMALL, "--checkpoint-dir", ckdir, "--checkpoint-every", "2",
                        "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from checkpoint at" in out
    assert "streamed == one-shot: True" in out


@pytest.mark.parametrize("shard", ["chunks", "detect", "layout", "all"])
def test_stream_runner_shard_names_the_roadmap(shard, capfd):
    """Every ``--shard`` mode runs, on two ranks the launcher spawns, and
    streams equal to one shot on both."""
    stream_runner.main([*_SMALL, "--shard", shard, "--ranks", "2", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "streamed == one-shot: True" in out
    assert f"mesh: 2 ranks (gloo), shard {shard}" in out
    devices = "devices=2" if shard in ("detect", "all") else "devices=1"
    assert devices in out


def test_stream_runner_resume_needs_a_checkpoint_dir():
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        stream_runner.main([*_SMALL, "--resume", "--device", "cpu"])


# ------------------------------------------------------------------ examples
def _example(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLES = {
    "gnn_fullbatch_torch": lambda tmp: [],
    "rounds_series_torch": lambda tmp: ["--out", str(tmp)],
    "serve_lm_torch": lambda tmp: [],
    "train_lm_torch": lambda tmp: ["--steps", "6", "--d-model", "32", "--layers", "2",
                                   "--vocab", "128", "--seq", "16", "--batch", "2",
                                   "--ckpt", str(tmp / "ckpt")],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_torch_example_runs_on_the_cpu(name, tmp_path, capsys):
    """Each of the port's examples (the reference's four last ones, ported)
    at a small size with ``--device cpu``: it runs to its end and its own
    checks hold (the train example's SIGTERM handler is removed after)."""
    import signal

    saved = signal.getsignal(signal.SIGTERM)
    try:
        _example(name).main(EXAMPLES[name](tmp_path) + ["--device", "cpu"])
    finally:
        signal.signal(signal.SIGTERM, saved)
    out = capsys.readouterr().out
    if name == "gnn_fullbatch_torch":
        assert "held-out accuracy" in out and "[gin sampled] done" in out
    elif name == "rounds_series_torch":
        assert [f"rounds_{r}_torch.svg" for r in (1, 2, 3, 4)] == sorted(
            p.name for p in tmp_path.glob("*.svg"))
    elif name == "serve_lm_torch":
        assert "served 6 requests" in out
    else:
        assert "simulated preemption → restored step 3" in out and "final loss" in out
