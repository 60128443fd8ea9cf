"""GNN example on PyTorch/CUDA: full-batch GAT node classification on a
planted-partition graph (cora-regime), plus a sampled-minibatch GIN run
through the CSR fanout sampler — the two GNN training modes, with the port
(``src/repro_torch``); ``examples/gnn_fullbatch.py`` is the reference package's version.

    PYTHONPATH=src python examples/gnn_fullbatch_torch.py               # on the GPU
    PYTHONPATH=src python examples/gnn_fullbatch_torch.py --device cpu  # plain versions

The GNN's message sums and its gathers' gradients run through kernel K7 on
the GPU (built with ``nvcc`` at first use).
"""
import argparse
import functools
import os
import sys
from dataclasses import replace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs.gnn_archs import smoke_gnn
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.graph import NeighborSampler, planted_partition
from repro_torch.graph.utils import to_csr
from repro_torch.models import gnn as gnn_lib
from repro_torch.models.param import init_params
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_loop import TrainConfig, make_train_step


def _tensors(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def full_batch_gat(dev) -> None:
    n, k = 600, 6
    edges, labels = planted_partition(n, k, 0.3, 0.01, seed=1)
    cfg = replace(smoke_gnn("gat"), d_feat=32, n_out=k, n_layers=2, d_hidden=32)
    params = init_params(prng.key(0), gnn_lib.param_specs(cfg), dev)
    rng = np.random.default_rng(0)
    # features: noisy one-hot-ish community signal
    feats = rng.standard_normal((n, 32)).astype(np.float32)
    feats[np.arange(n), labels % 32] += 2.0
    train_mask = (rng.random(n) < 0.5).astype(np.float32)
    batch = _tensors({"feats": feats, "edges": edges, "labels": labels, "mask": train_mask},
                     dev)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3))
    step = make_train_step(functools.partial(gnn_lib.gnn_loss, cfg), tcfg)
    state = init_opt_state(params, tcfg.adamw)
    for i in range(60):
        params, state, m = step(params, state, batch)
        if i % 20 == 0:
            print(f"[gat full-batch] step {i} loss {float(m['loss']):.3f}")
    with torch.no_grad():
        out = gnn_lib.forward(cfg, params, batch)
    pred = out.argmax(-1).cpu().numpy()
    test = train_mask == 0
    acc = float((pred[test] == labels[test]).mean())
    print(f"[gat full-batch] held-out accuracy {acc:.2%}")
    assert acc > 0.5


def sampled_gin(dev) -> None:
    n = 2000
    edges, labels = planted_partition(n, 10, 0.2, 0.005, seed=2)
    indptr, indices = to_csr(edges, n)
    sampler = NeighborSampler(indptr, indices, fanouts=(10, 5))
    cfg = replace(smoke_gnn("gin"), d_feat=16, n_out=10)
    params = init_params(prng.key(1), gnn_lib.param_specs(cfg), dev)
    rng = np.random.default_rng(3)
    feats_all = rng.standard_normal((n, 16)).astype(np.float32)
    feats_all[np.arange(n), labels % 16] += 2.0

    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3))
    step = make_train_step(functools.partial(gnn_lib.gnn_loss, cfg), tcfg)
    state = init_opt_state(params, tcfg.adamw)
    for i in range(30):
        seeds = rng.integers(0, n, size=64)
        sub = sampler.sample(seeds, rng)
        cap = sub.nodes.shape[0]
        feats = np.zeros((cap, 16), np.float32)
        valid = sub.nodes >= 0
        feats[valid] = feats_all[sub.nodes[valid]]
        lab = np.zeros(cap, np.int32)
        lab[valid] = labels[sub.nodes[valid]]
        batch = _tensors({"feats": feats, "edges": sub.edges, "labels": lab,
                          "mask": sub.seed_mask.astype(np.float32)}, dev)
        params, state, m = step(params, state, batch)
        if i % 10 == 0:
            print(f"[gin sampled] step {i} loss {float(m['loss']):.3f} "
                  f"(subgraph {sub.n_nodes} nodes / {sub.n_edges} edges)")
    print("[gin sampled] done")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_batch_gat(dev)
    sampled_gin(dev)


if __name__ == "__main__":
    main()
