"""SASRec recsys architecture (exact config from the assignment)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, recsys_shapes
from repro_torch.models.sasrec import SASRecConfig


def sasrec() -> ArchConfig:
    # [arXiv:1808.09781; paper] embed_dim 50, 2 blocks, 1 head, seq_len 50,
    # self-attentive sequential interaction. Item table sized for the
    # retrieval_cand cell (10⁶ candidates) → 2²⁰ items (mesh-divisible).
    model = SASRecConfig(name="sasrec", n_items=1_048_576, embed_dim=50,
                         n_blocks=2, n_heads=1, seq_len=50)
    return ArchConfig(name="sasrec", family="recsys", profile="recsys",
                      model=model, shapes=recsys_shapes())


def smoke_sasrec() -> SASRecConfig:
    return SASRecConfig(name="smoke-sasrec", n_items=500, embed_dim=16,
                        n_blocks=2, n_heads=1, seq_len=12)
