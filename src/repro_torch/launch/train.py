"""Training launcher: real steps on the card (or the CPU with ``--device
cpu``), with checkpoint/restart, the SIGTERM preemption hook, the
straggler watchdog and deterministic data (every batch a function of the
step), the reference's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --preset smoke \\
        --steps 20 --ckpt-dir ckpt --ckpt-every 5

``--preset smoke`` swaps in the reduced config of the same family;
``--preset full`` (the assigned config) refuses, as the reference's does:
the training cells at full size run through ``launch.steps.build_step``.
A run whose ``--ckpt-dir`` holds a checkpoint resumes from its newest one.

``--mesh DATAxMODEL`` trains on a ``ModelMesh`` of DATA·MODEL ranks (the
arch's sharding profile; every rank holds its blocks of the parameters,
the optimizer state and each batch), under ``torch.distributed.run``:

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch yi-6b --mesh 1x2 --device cpu

or with ``--ranks N`` (``launch.mesh.spawn_local``). Ranks sharing one card
need ``--backend gloo``. Each rank writes its own blocks under
``--ckpt-dir``/rank{r:03d}, and a resumed run restores the newest step
that every rank holds; only rank 0 prints.
"""
from __future__ import annotations

import argparse
import functools
import signal
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.gnn_archs import smoke_gnn
from repro_torch.configs.lm_archs import smoke_lm
from repro_torch.configs.sasrec import smoke_sasrec
from repro_torch.core import prng
from repro_torch.data.pipeline import LMStream, MoleculeStream, SASRecStream
from repro_torch.device import resolve_device
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import sasrec as sas_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.param import init_params
from repro_torch.obs.cli import add_obs_args, obs_session
from repro_torch.resilience import checkpoint as ckpt_lib
from repro_torch.train.fault_tolerance import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import StepWatchdog, TrainConfig, make_train_step


def build_smoke(arch_name: str, batch: int, seq: int):
    """``(cfg, specs, loss_fn, stream)`` of the reduced config of the
    arch's family."""
    arch = get_config(arch_name)
    if arch.family == "lm":
        cfg = smoke_lm(moe=arch.model.moe is not None,
                       sliding=arch.model.sliding_window is not None)
        loss_fn = functools.partial(tfm.lm_loss, cfg)
        specs = tfm.param_specs(cfg)
        stream = LMStream(vocab=cfg.vocab, batch=batch, seq_len=seq)
    elif arch.family == "gnn":
        cfg = replace(smoke_gnn(arch.model.arch), task="graph_class", n_out=2)
        loss_fn = functools.partial(gnn_lib.gnn_loss, cfg)
        specs = gnn_lib.param_specs(cfg)
        stream = MoleculeStream(batch=batch, n_nodes=12, n_edges=24, d_feat=cfg.d_feat)
    elif arch.family == "recsys":
        cfg = smoke_sasrec()
        loss_fn = functools.partial(sas_lib.sasrec_loss, cfg)
        specs = sas_lib.param_specs(cfg)
        stream = SASRecStream(n_items=cfg.n_items, batch=batch, seq_len=cfg.seq_len)
    else:
        raise ValueError(f"{arch_name}: the {arch.family} family has no training step")
    return cfg, specs, loss_fn, stream


def _mesh_step(arch_name: str, cfg, loss_fn, stream, batch: int, seq: int, tcfg, mesh):
    """The smoke config's train step on ``mesh`` through ``build_step``:
    ``(step_fn, (param, state, batch) specs)``."""
    from repro_torch.launch.steps import build_step

    arch = replace(get_config(arch_name), model=cfg)
    if arch.family == "lm":
        shape = ShapeSpec("train", "train", seq_len=seq, global_batch=batch)
    elif arch.family == "recsys":
        shape = ShapeSpec("train_batch", "train", global_batch=batch)
    else:
        shape = ShapeSpec("train", "graph_train", n_nodes=batch * stream.n_nodes,
                          n_edges=batch * stream.n_edges, d_feat=cfg.d_feat, n_out=cfg.n_out,
                          task=cfg.task, n_graphs=batch)
    built = build_step(arch, shape, mesh)
    step_fn = make_train_step(functools.partial(loss_fn, place=built.place), tcfg,
                              mesh=built.place)
    return step_fn, built.in_specs


def _restore_agreed(ckpt_dir: str, like, mesh):
    """The newest step every rank holds, restored on this rank: ``(step,
    tree, meta)`` or ``(None, None, {})``."""
    from repro_torch.sharding.collectives import all_reduce

    mine = ckpt_lib.latest_step(ckpt_dir)
    step = torch.tensor([-1 if mine is None else mine], dtype=torch.int64, device=mesh.device)
    step = int(all_reduce(step, mesh, "min").item())
    if step < 0:
        return None, None, {}
    tree, meta = ckpt_lib.restore(ckpt_dir, step, like)
    return step, tree, meta


def run(arch_name: str, steps: int, batch: int, seq: int, ckpt_dir: str,
        ckpt_every: int, lr: float, log_every: int = 10, state_bits: int = 32,
        device=None, mesh=None) -> dict:
    """``steps`` steps of the arch's smoke config; ``mesh`` (a
    ``ModelMesh``) trains it on the mesh's ranks, this rank's part."""
    device = resolve_device(device) if mesh is None else mesh.device
    cfg, specs, loss_fn, stream = build_smoke(arch_name, batch, seq)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=lr, state_bits=state_bits))
    params = init_params(prng.key(0), specs, device)  # the reference's PRNGKey(0)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    if mesh is None:
        step_fn, in_specs = make_train_step(loss_fn, tcfg), None
    else:
        from repro_torch.sharding.params import shard_tree

        step_fn, in_specs = _mesh_step(arch_name, cfg, loss_fn, stream, batch, seq, tcfg, mesh)
        params = shard_tree(params, in_specs[0], mesh)
        if mesh.size > 1:
            ckpt_dir = f"{ckpt_dir}/rank{mesh.rank:03d}"
    state = init_opt_state(params, tcfg.adamw)

    mgr = CheckpointManager(ckpt_dir, every_steps=ckpt_every)
    previous = signal.getsignal(signal.SIGTERM)
    mgr.install_preemption_handler()
    try:
        if mesh is None:
            start, restored, meta = mgr.restore_latest((params, state))
        else:
            start, restored, meta = _restore_agreed(ckpt_dir, (params, state), mesh)
        if start is not None:
            params, state = restored
            say(f"restored checkpoint @ step {start} ({meta})")
            start += 1
        else:
            start = 0

        watchdog = StepWatchdog()
        losses = []
        t0 = time.perf_counter()
        for step in range(start, steps):
            b = {k: torch.as_tensor(v, device=device) for k, v in stream.batch_at(step).items()}
            if in_specs is not None:
                b = shard_tree(b, in_specs[2], mesh)
            watchdog.start()
            params, state, metrics = step_fn(params, state, b)
            loss = float(metrics["loss"])  # waits for the step
            straggler = watchdog.stop()
            losses.append(loss)
            if straggler:
                say(f"step {step}: STRAGGLER detected (>{watchdog.threshold}× median) "
                      "— pod-scale policy: checkpoint + reschedule")
                mgr.save(step, (params, state), extra={"reason": "straggler"})
            if mgr.should_save(step):
                mgr.save(step, (params, state), extra={"loss": loss})
            if step % log_every == 0:
                say(f"step {step}: loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
        wall = time.perf_counter() - t0
        if losses:
            mgr.save(steps - 1, (params, state), extra={"final_loss": losses[-1]})
            say(f"done: {len(losses)} steps in {wall:.1f}s; "
                  f"loss {losses[0]:.4f} → {losses[-1]:.4f}")
        return {"losses": losses, "wall_s": wall}
    finally:
        signal.signal(signal.SIGTERM, previous)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--state-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: train on a (data, model) mesh of that many ranks")
    ap.add_argument("--ranks", type=int, default=0,
                    help="start the mesh's ranks here (spawn_local) instead of under "
                         "torch.distributed.run")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend (gloo lets ranks share one card)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.preset == "full":
        raise SystemExit(
            "--preset full trains the assigned config, which needs more than one card; "
            "build a training cell with repro_torch.launch.steps.build_step instead."
        )
    if args.mesh is not None and args.ranks > 1:
        import tempfile

        from repro_torch.launch.mesh import spawn_local

        with tempfile.TemporaryDirectory() as d:
            spawn_local(_rank_main, args.ranks, backend=args.backend, device=args.device,
                        init_file=f"{d}/store", args=(argv,), timeout=24 * 3600)
        return
    with obs_session(args):
        mesh = None
        if args.mesh is not None:
            from repro_torch.launch.mesh import make_model_mesh

            mesh = make_model_mesh(_mesh_shape(args.mesh), ("data", "model"),
                                   backend=args.backend, device=args.device)
        run(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir, args.ckpt_every,
            args.lr, state_bits=args.state_bits, device=args.device, mesh=mesh)


def _mesh_shape(text: str) -> tuple:
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text!r}: expected DATAxMODEL, e.g. 1x2") from None
    return d, m


def _rank_main(_stream_mesh, argv) -> None:
    """One rank of ``--ranks``: this launcher without ``--ranks``."""
    argv = list(argv)
    if "--ranks" in argv:
        i = argv.index("--ranks")
        del argv[i:i + 2]
    main(argv)


if __name__ == "__main__":
    main()
