"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeSpec, input_specs
from repro_torch.configs.biggraphvis import biggraphvis
from repro_torch.configs.gnn_archs import gat_cora, gin_tu, graphcast, meshgraphnet
from repro_torch.configs.lm_archs import (
    gemma3_4b,
    granite_moe_1b_a400m,
    kimi_k2_1t_a32b,
    mistral_large_123b,
    yi_6b,
)
from repro_torch.configs.sasrec import sasrec

REGISTRY = {
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "yi-6b": yi_6b,
    "gemma3-4b": gemma3_4b,
    "mistral-large-123b": mistral_large_123b,
    "gin-tu": gin_tu,
    "meshgraphnet": meshgraphnet,
    "graphcast": graphcast,
    "gat-cora": gat_cora,
    "sasrec": sasrec,
    "biggraphvis": biggraphvis,
}

ASSIGNED = [k for k in REGISTRY if k != "biggraphvis"]


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]()


def all_cells(include_bgv: bool = True):
    """Every (arch, shape) dry-run cell, skipped cells included (flagged)."""
    for name, builder in REGISTRY.items():
        if name == "biggraphvis" and not include_bgv:
            continue
        arch = builder()
        for shape in arch.shapes.values():
            yield arch, shape
