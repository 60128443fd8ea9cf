"""The rank side of ``tests/test_torch_sharded.py``: every case one rank
runs, in one spawned group per rank count.

Ranks are fresh processes that import this module, so it imports only
``numpy``, ``torch`` and ``repro_torch`` (never ``jax`` or the reference
package). ``run_all`` runs each case on the rank's ``StreamMesh`` and writes
the rank's results to ``{out}/rank{r}.pkl``; the test module compares them
with single-rank runs and with the reference.
"""
from __future__ import annotations

import os
import pickle
import signal
import warnings
from dataclasses import replace

import numpy as np
import torch

# The reference test's graph (tests/test_sharded_pipeline.py).
N, COMMUNITIES, P_IN, P_OUT, SEED = 768, 16, 0.3, 0.002, 11
# The resilience tests' sizes (tests/test_resilience.py): 32 chunks a pass.
RN, RE, RCHUNK, RROUNDS, RBLOCK, RS_CAP, RMAX_SE = 240, 2000, 64, 2, 32, 512, 2048


def graph():
    from repro_torch.graph.generators import planted_partition

    edges, _ = planted_partition(N, COMMUNITIES, P_IN, P_OUT, seed=SEED)
    return edges


def pipeline_cfg(edges, block=128, iterations=5, init="degree"):
    import repro_torch
    from repro_torch.graph.utils import mode_degree

    cfg = repro_torch.default_config(N, len(edges), mode_degree(edges, N), rounds=2,
                                     iterations=iterations, init=init)
    return replace(cfg, scoda=replace(cfg.scoda, block_size=block))


def result_arrays(res) -> dict:
    """Every output of a ``BGVResult`` the tests compare, as host arrays."""
    sg = res.supergraph
    return {
        "labels": np.asarray(res.labels), "positions": np.asarray(res.positions),
        "sizes": np.asarray(res.sizes), "groups": np.asarray(res.groups),
        "sg_edges": sg.edges.cpu().numpy(), "sg_weights": sg.weights.cpu().numpy(),
        "n_supernodes": res.n_supernodes, "n_superedges": res.n_superedges,
        "modularity": res.modularity, "devices": res.stream.devices,
        "peak_device_bytes": res.stream.peak_device_bytes,
        "peak_local_bytes": res.stream.peak_local_bytes,
    }


def resilience_inputs():
    from repro_torch.core.cms import CMSConfig
    from repro_torch.core.scoda import ScodaConfig

    rng = np.random.default_rng(7)
    edges = rng.integers(0, RN, (RE, 2), dtype=np.int32)
    return (edges, ScodaConfig(degree_threshold=8, rounds=RROUNDS, block_size=RBLOCK),
            CMSConfig(rows=4, cols=256))


def resilience_run(mesh, source=None, **kw):
    """``stream_pipeline`` at the resilience sizes → host arrays."""
    import repro_torch

    edges, scoda, cms = resilience_inputs()
    scfg = kw.pop("stream_cfg", None) or repro_torch.StreamConfig(
        chunk_size=RCHUNK, mesh=mesh, shard_detect=mesh is not None)
    labels, gdeg, sg, q, stats = repro_torch.stream_pipeline(
        edges if source is None else source, RN, scoda, cms, RS_CAP, RMAX_SE, scfg,
        device="cpu", **kw)
    return {"labels": labels.numpy(), "gdeg": gdeg.numpy(), "sg_edges": sg.edges.numpy(),
            "sg_weights": sg.weights.numpy(), "sizes": sg.sizes.numpy(),
            "sg_labels": sg.labels.numpy(), "q": float(q), "resumed_at": stats.resumed_at,
            "devices": stats.devices, "retries": stats.retries,
            "quarantined": list(stats.quarantined_chunk_ids),
            "dropped": stats.dropped_edges}


def chaos_store(edges):
    """The fault plan of the validated case: a transient I/O error and a
    transient short read (one failed attempt each), a permanently failing
    chunk and a bit-flip, at chunk starts."""
    from repro_torch.resilience import ChaosConfig, ChaosEdgeStore

    c = RCHUNK
    inner = ChaosEdgeStore(edges, ChaosConfig(io_error_offsets=(9 * c,),
                                              bitflip_offsets=(20 * c,), seed=3))
    return inner, ChaosEdgeStore(inner, ChaosConfig(
        io_error_offsets=(3 * c,), truncate_offsets=(14 * c,), truncate_rows=10,
        transient_attempts=1))


def _case_pipelines(mesh, out):
    import repro_torch

    edges = graph()
    cfg = pipeline_cfg(edges)
    for agg in ("merge", "lexsort"):
        scfg = repro_torch.StreamConfig(chunk_size=256, agg_backend=agg, mesh=mesh,
                                        shard_detect=True, shard_layout=True)
        out[f"pipeline_{agg}"] = result_arrays(
            repro_torch.biggraphvis(edges, N, cfg, scfg))
    # The default configuration's "random" init: every rank draws the
    # reference's start.
    scfg = repro_torch.StreamConfig(chunk_size=256, mesh=mesh, shard_detect=True,
                                    shard_layout=True)
    out["pipeline_random"] = result_arrays(
        repro_torch.biggraphvis(edges, N, pipeline_cfg(edges, init="random"), scfg))
    # Block 81 and chunk 81 divide by neither 2 nor 4: both passes fall back.
    cfg81 = pipeline_cfg(edges, block=81)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = repro_torch.biggraphvis(edges, N, cfg81, repro_torch.StreamConfig(
            chunk_size=81, mesh=mesh, shard_detect=True))
    out["fallback"] = {**result_arrays(res), "warnings": [str(w.message) for w in caught]}


def _case_layouts(mesh, out):
    from repro_torch.core import forceatlas2 as fa2

    edges = torch.as_tensor(graph()[:512])
    w = torch.ones(edges.shape[0])
    mass = torch.zeros(N).index_add_(0, edges[:, 0].long(), torch.ones(edges.shape[0])) + 1
    out["start"] = fa2.initial_positions(edges, mass, N, fa2.FA2Config()).numpy()
    for rep in ("exact", "grid"):
        cfg = fa2.FA2Config(iterations=4, repulsion=rep, grid_size=8, grid_window=8)
        pos, trace, it = fa2.layout_sharded(edges, w, mass, N, cfg, mesh, device="cpu")
        out[f"layout_{rep}"] = (pos.numpy(), trace.numpy(), it)
    # A bfloat16 exact layout (K2's row entry and the attraction in the
    # layout's type), widened to float32 to leave: numpy has no bfloat16.
    cfg = fa2.FA2Config(iterations=4, dtype="bfloat16")
    pos, trace, it = fa2.layout_sharded(edges, w, mass, N, cfg, mesh, device="cpu")
    assert pos.dtype == trace.dtype == torch.bfloat16
    out["layout_exact_bf16"] = (pos.float().numpy(), trace.float().numpy(), it)
    # The adaptive stop, grid rebuilt every other iteration, nan_guard on.
    cfg = fa2.FA2Config(iterations=30, repulsion="grid", grid_size=8, grid_window=8,
                        grid_rebuild=2, stop_tolerance=0.5, min_iterations=3,
                        nan_guard=True)
    pos, trace, it = fa2.layout_sharded(edges, w, mass, N, cfg, mesh, device="cpu")
    out["layout_adaptive"] = (pos.numpy(), trace.numpy(), it)
    # Fallbacks: n = 99 divides by neither 2 nor 4; a bfloat16 grid layout.
    fa2._FALLBACK_WARNED.clear()
    small = torch.tensor([[0, 1], [1, 2], [2, 3]], dtype=torch.int32)
    falls = []
    for n, cfg in ((99, fa2.FA2Config(iterations=2)),
                   (99, fa2.FA2Config(iterations=2)),
                   (N, fa2.FA2Config(iterations=3, repulsion="grid", grid_size=8,
                                     grid_window=8, dtype="bfloat16"))):
        e = small if n == 99 else edges[:256]
        m = torch.ones(n) if n == 99 else mass
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pos, _, _ = fa2.layout_sharded(e, torch.ones(e.shape[0]), m, n, cfg, mesh,
                                           device="cpu")
        falls.append((pos.to(torch.float32).numpy(), str(pos.dtype),
                      [str(w.message) for w in caught]))
    out["layout_fallbacks"] = falls


def _case_put(mesh, out):
    import repro_torch
    from repro_torch.launch.stream_runner import StreamRunner, StreamRunnerConfig

    edges = graph()
    cfg = pipeline_cfg(edges)
    runner = StreamRunner(cfg, StreamRunnerConfig(shard_chunks=True), mesh=mesh)
    odd = np.ascontiguousarray(edges[: mesh.size + 1], np.int32)
    before = runner.put(odd).numpy()
    runner._trash = N  # what run() sets before streaming
    after = runner.put(odd).numpy()
    placed = runner.place(odd).numpy()
    runner = StreamRunner(cfg, StreamRunnerConfig(
        stream=repro_torch.StreamConfig(chunk_size=255), shard_chunks=True), mesh=mesh)
    out["put"] = {"before": before, "after": after, "placed": placed,
                  "chunks": result_arrays(runner.run(edges, N))}


def _case_resume(mesh, out, tmp, ckpt_in):
    """Resume the checkpoints the parent wrote (one rank and the
    reference), then write one here, killed in round 1."""
    from repro_torch.resilience import KillSwitch, SimulatedPreemption, StreamCheckpointer

    for name, d in ckpt_in.items():
        out[f"resume_{name}"] = resilience_run(
            mesh, checkpoint=StreamCheckpointer(d), resume=True)
    d = os.path.join(tmp, "written")
    ck = StreamCheckpointer(d, on_boundary=KillSwitch(RE // RCHUNK + 8))
    try:
        resilience_run(mesh, checkpoint=ck)
        killed = False
    except SimulatedPreemption:
        killed = True
    out["written"] = {"dir": d, "killed": killed, "saves": ck.saves}


def _case_sigterm(mesh, out, tmp):
    """Rank 1 alone is sent SIGTERM after boundary 40; every rank must stop
    at the same boundary, after one agreed save."""
    from repro_torch.resilience import Preempted, StreamCheckpointer

    seen = []

    def hook(phase, rnd, chunk):
        seen.append((phase, rnd, chunk))
        if mesh.rank == 1 and len(seen) == 40:
            os.kill(os.getpid(), signal.SIGTERM)

    d = os.path.join(tmp, "sigterm")
    ck = StreamCheckpointer(d, every_chunks=0, exit_on_preempt=True, on_boundary=hook)
    old = signal.getsignal(signal.SIGTERM)
    ck.install_preemption_handler()
    try:
        resilience_run(mesh, checkpoint=ck)
        stopped = None
    except Preempted:
        stopped = len(seen)
    finally:
        signal.signal(signal.SIGTERM, old)
    out["sigterm"] = {"dir": d, "stopped_after": stopped, "saves": ck.saves}


def _case_chaos(mesh, out):
    import repro_torch
    from repro_torch.resilience import ValidationPolicy

    edges, _, _ = resilience_inputs()
    inner, store = chaos_store(edges)
    scfg = repro_torch.StreamConfig(chunk_size=RCHUNK, mesh=mesh, shard_detect=True,
                                    validation=ValidationPolicy(retry_backoff_s=0.0))
    got = resilience_run(mesh, source=store, stream_cfg=scfg)
    out["chaos"] = {**got, "injected": {**store.injected, **inner.injected}}


def run_all(mesh, out_dir, ckpt_in):
    torch.set_num_threads(2)
    out = {"rank": mesh.rank, "size": mesh.size}
    tmp = os.path.join(out_dir, f"rank{mesh.rank}")
    os.makedirs(tmp, exist_ok=True)
    _case_pipelines(mesh, out)
    _case_layouts(mesh, out)
    _case_put(mesh, out)
    # The checkpoint directories are shared: rank 0's path names them.
    shared = os.path.join(out_dir, "rank0")
    _case_resume(mesh, out, shared, ckpt_in)
    _case_sigterm(mesh, out, shared)
    _case_chaos(mesh, out)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
