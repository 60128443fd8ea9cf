"""End-to-end training driver on PyTorch/CUDA: a ~25M-param GQA transformer
(reduced yi-family config) trained for a few hundred steps on the synthetic
Zipf token stream, with periodic checkpointing and a mid-run simulated
preemption + restore, with the port (``src/repro_torch``);
``examples/train_lm.py`` is the reference package's version.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--d-model 256]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20 --d-model 64

(~100M-param preset: --d-model 512 --layers 12 --vocab 32768 — same code,
longer wall-clock.)
"""
import argparse
import functools
import math
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.core import prng
from repro_torch.data.pipeline import LMStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.param import init_params, param_count
from repro_torch.train.fault_tolerance import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import StepWatchdog, TrainConfig, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "train_lm_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = tfm.LMConfig(
        name="train-lm-example", n_layers=args.layers, d_model=args.d_model,
        n_heads=8, n_kv_heads=4, head_dim=args.d_model // 8,
        d_ff=args.d_model * 4, vocab=args.vocab, vocab_padded=args.vocab,
        act_dtype=torch.float32, q_chunk=0,
    )
    specs = tfm.param_specs(cfg)
    print(f"model: {param_count(specs)/1e6:.1f}M params")

    if not args.resume and os.path.isdir(args.ckpt):
        shutil.rmtree(args.ckpt)

    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3))
    step_fn = make_train_step(functools.partial(tfm.lm_loss, cfg), tcfg)

    params = init_params(prng.key(0), specs, dev)
    state = init_opt_state(params, tcfg.adamw)
    stream = LMStream(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq)

    mgr = CheckpointManager(args.ckpt, every_steps=100)
    mgr.install_preemption_handler()
    start, restored, _ = mgr.restore_latest((params, state), device=dev)
    if start is not None:
        params, state = restored
        print(f"resumed from step {start}")
        start += 1
    else:
        start = 0

    def batch_at(step):
        return {k: torch.as_tensor(v, device=dev) for k, v in stream.batch_at(step).items()}

    wd = StepWatchdog()
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        wd.start()
        params, state, m = step_fn(params, state, batch_at(step))
        loss = float(m["loss"])  # waits for the step
        if wd.stop():
            print(f"step {step}: straggler detected — checkpointing")
            mgr.save(step, (params, state))
        if mgr.should_save(step):
            mgr.save(step, (params, state), extra={"loss": loss})
        if step % 25 == 0:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"({(time.perf_counter()-t0)/(step-start+1):.2f}s/step)")
        if step == args.steps // 2 and not args.resume:
            # simulate a preemption: checkpoint, drop state, restore
            mgr.save(step, (params, state), extra={"reason": "simulated preemption"})
            s, (params, state), _ = mgr.restore_latest((params, state), device=dev)
            print(f"step {step}: simulated preemption → restored step {s}")
    print(f"done: final loss {loss:.4f} in {time.perf_counter()-t0:.0f}s")
    assert math.isfinite(loss)


if __name__ == "__main__":
    main()
