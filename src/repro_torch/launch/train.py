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
"""
from __future__ import annotations

import argparse
import functools
import signal
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.gnn_archs import smoke_gnn
from repro_torch.configs.lm_archs import smoke_lm
from repro_torch.configs.sasrec import smoke_sasrec
from repro_torch.data.pipeline import LMStream, MoleculeStream, SASRecStream
from repro_torch.device import resolve_device
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import sasrec as sas_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.param import init_params
from repro_torch.obs.cli import add_obs_args, obs_session
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


def run(arch_name: str, steps: int, batch: int, seq: int, ckpt_dir: str,
        ckpt_every: int, lr: float, log_every: int = 10, state_bits: int = 32,
        device=None) -> dict:
    device = resolve_device(device)
    cfg, specs, loss_fn, stream = build_smoke(arch_name, batch, seq)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=lr, state_bits=state_bits))
    step_fn = make_train_step(loss_fn, tcfg)

    params = init_params(torch.Generator(device=device).manual_seed(0), specs)
    state = init_opt_state(params, tcfg.adamw)

    mgr = CheckpointManager(ckpt_dir, every_steps=ckpt_every)
    previous = signal.getsignal(signal.SIGTERM)
    mgr.install_preemption_handler()
    try:
        start, restored, meta = mgr.restore_latest((params, state))
        if start is not None:
            params, state = restored
            print(f"restored checkpoint @ step {start} ({meta})")
            start += 1
        else:
            start = 0

        watchdog = StepWatchdog()
        losses = []
        t0 = time.perf_counter()
        for step in range(start, steps):
            b = {k: torch.as_tensor(v, device=device) for k, v in stream.batch_at(step).items()}
            watchdog.start()
            params, state, metrics = step_fn(params, state, b)
            loss = float(metrics["loss"])  # waits for the step
            straggler = watchdog.stop()
            losses.append(loss)
            if straggler:
                print(f"step {step}: STRAGGLER detected (>{watchdog.threshold}× median) "
                      "— pod-scale policy: checkpoint + reschedule")
                mgr.save(step, (params, state), extra={"reason": "straggler"})
            if mgr.should_save(step):
                mgr.save(step, (params, state), extra={"loss": loss})
            if step % log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.3f}", flush=True)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
        wall = time.perf_counter() - t0
        if losses:
            mgr.save(steps - 1, (params, state), extra={"final_loss": losses[-1]})
            print(f"done: {len(losses)} steps in {wall:.1f}s; "
                  f"loss {losses[0]:.4f} → {losses[-1]:.4f}")
        return {"losses": losses, "wall_s": wall}
    finally:
        signal.signal(signal.SIGTERM, previous)


def main(argv=None) -> None:
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
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.preset == "full":
        raise SystemExit(
            "--preset full trains the assigned config, which needs more than one card; "
            "build a training cell with repro_torch.launch.steps.build_step instead."
        )
    with obs_session(args):
        run(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir, args.ckpt_every,
            args.lr, state_bits=args.state_bits, device=args.device)


if __name__ == "__main__":
    main()
