"""Batched serving example on PyTorch/CUDA: continuous-batching greedy
decode over a shared KV cache (``repro_torch.serve.engine.LMEngine``) with
a small random-weight model — requests of different lengths join and leave
the slot pool between ticks; ``examples/serve_lm.py`` is the reference package's version.

    PYTHONPATH=src python examples/serve_lm_torch.py               # on the GPU
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.param import init_params
from repro_torch.serve.engine import LMEngine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = tfm.LMConfig(
        name="serve-example", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=101, vocab_padded=112,
        act_dtype=torch.float32, q_chunk=0,
    )
    params = init_params(prng.key(1), tfm.param_specs(cfg), dev)
    engine = LMEngine(cfg, params, n_slots=4, max_len=64, device=dev)

    rng = np.random.default_rng(0)
    backlog = [
        Request(prompt=rng.integers(1, cfg.vocab, size=int(p)), max_new=int(n))
        for p, n in [(5, 8), (3, 12), (9, 6), (2, 10), (4, 7), (6, 9)]
    ]
    done = []
    tick = 0
    while backlog or engine.n_live:
        while backlog and engine.submit(backlog[0]):
            backlog.pop(0)
        done += engine.tick()
        tick += 1
        print(f"tick {tick:3d}: live={engine.n_live} queued={len(backlog)} done={len(done)}")
    for i, req in enumerate(done):
        assert len(req.out) == req.max_new
        print(f"req{i}: prompt[{len(req.prompt)}] -> {req.out}")
    print(f"served {len(done)} requests in {tick} ticks (continuous batching)")


if __name__ == "__main__":
    main()
