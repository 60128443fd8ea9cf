"""The four assigned GNN architectures (exact configs from the assignment)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, gnn_shapes
from repro_torch.models.gnn import GNNConfig


def gin_tu() -> ArchConfig:
    # [arXiv:1810.00826; paper] 5 layers, d_hidden 64, sum aggregator,
    # learnable eps.
    model = GNNConfig(name="gin-tu", arch="gin", n_layers=5, d_hidden=64,
                      d_feat=16, n_out=2)
    return ArchConfig(name="gin-tu", family="gnn", profile="gnn", model=model,
                      shapes=gnn_shapes("gin"))


def meshgraphnet() -> ArchConfig:
    # [arXiv:2010.03409; unverified] 15 message-passing steps, d_hidden 128,
    # 2-layer MLPs, sum aggregation.
    model = GNNConfig(name="meshgraphnet", arch="meshgraphnet", n_layers=15,
                      d_hidden=128, d_feat=16, n_out=3, task="node_reg")
    return ArchConfig(name="meshgraphnet", family="gnn", profile="gnn",
                      model=model, shapes=gnn_shapes("meshgraphnet"))


def graphcast() -> ArchConfig:
    # [arXiv:2212.12794; unverified] encoder-processor-decoder mesh GNN,
    # 16 processor layers, d_hidden 512, 227 output vars.
    model = GNNConfig(name="graphcast", arch="graphcast", n_layers=16,
                      d_hidden=512, d_feat=227, n_out=227, task="node_reg")
    return ArchConfig(name="graphcast", family="gnn", profile="gnn",
                      model=model, shapes=gnn_shapes("graphcast"))


def gat_cora() -> ArchConfig:
    # [arXiv:1710.10903; paper] 2 layers, 8 heads × 8 hidden, attention
    # aggregator.
    model = GNNConfig(name="gat-cora", arch="gat", n_layers=2, d_hidden=64,
                      n_heads=8, d_feat=1433, n_out=7)
    return ArchConfig(name="gat-cora", family="gnn", profile="gnn",
                      model=model, shapes=gnn_shapes("gat"))


def smoke_gnn(arch: str) -> GNNConfig:
    return GNNConfig(name=f"smoke-{arch}", arch=arch, n_layers=2, d_hidden=16,
                     n_heads=2 if arch == "gat" else 1, d_feat=8, n_out=3)
