"""The five assigned LM-family architectures, exact configs from the
assignment table (sources noted per entry), as the reference's
``configs/lm_archs.py`` gives them."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, lm_shapes, pad_to
from repro_torch.models.transformer import LMConfig, MoESpec


def kimi_k2_1t_a32b() -> ArchConfig:
    # [arXiv:2501.kimi2; unverified] 61L d=7168 64H (GQA kv=8) per-expert
    # d_ff=2048, vocab 163840, MoE 384e top-8 (+1 shared) — ~1T total.
    model = LMConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=2048, vocab=163840,
        vocab_padded=163840,
        moe=MoESpec(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
    )
    return ArchConfig(
        name="kimi-k2-1t-a32b", family="lm", profile="tp", model=model,
        shapes=lm_shapes(sub_quadratic=False), opt_state_bits=8,
        microbatch_train=4,
        train_param_dtype=torch.bfloat16,  # 1 T parameters: bf16 weights for training
    )


def granite_moe_1b_a400m() -> ArchConfig:
    # [hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 24L d=1024 16H kv=8,
    # per-expert d_ff=512, MoE 32e top-8, vocab 49155 (padded →49280 for
    # 16-way vocab sharding).
    model = LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        vocab_padded=pad_to(49155, 16 * 8),
        moe=MoESpec(n_experts=32, top_k=8, d_ff_expert=512),
    )
    return ArchConfig(
        name="granite-moe-1b-a400m", family="lm", profile="tp", model=model,
        shapes=lm_shapes(sub_quadratic=False),
    )


def yi_6b() -> ArchConfig:
    # [arXiv:2403.04652; hf] llama-arch GQA: 32L d=4096 32H kv=4 d_ff=11008
    # vocab 64000.
    model = LMConfig(
        name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
        head_dim=128, d_ff=11008, vocab=64000, vocab_padded=64000,
    )
    return ArchConfig(
        name="yi-6b", family="lm", profile="tp", model=model,
        shapes=lm_shapes(sub_quadratic=False),
    )


def gemma3_4b() -> ArchConfig:
    # [hf:google/gemma-3-4b-pt; unverified] 34L d=2560 8H kv=4 head_dim 256
    # d_ff=10240 vocab 262144; 5:1 local:global sliding window (1024).
    model = LMConfig(
        name="gemma3-4b", n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        head_dim=256, d_ff=10240, vocab=262144, vocab_padded=262144,
        sliding_window=1024, global_every=6,
    )
    return ArchConfig(
        name="gemma3-4b", family="lm", profile="tp", model=model,
        # hybrid local:global ⇒ sub-quadratic: long_500k RUNS for this arch
        shapes=lm_shapes(sub_quadratic=True),
    )


def mistral_large_123b() -> ArchConfig:
    # [hf:mistralai/Mistral-Large-Instruct-2407; unverified] 88L d=12288
    # 96H kv=8 d_ff=28672 vocab 32768.
    model = LMConfig(
        name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
        n_kv_heads=8, head_dim=128, d_ff=28672, vocab=32768, vocab_padded=32768,
    )
    return ArchConfig(
        name="mistral-large-123b", family="lm", profile="tp", model=model,
        shapes=lm_shapes(sub_quadratic=False), microbatch_train=2,
    )


def smoke_lm(moe: bool = False, sliding: bool = False) -> LMConfig:
    """Reduced same-family config for CPU smoke tests."""
    return LMConfig(
        name="smoke-lm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=97, vocab_padded=112,
        moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1) if moe else None,
        sliding_window=8 if sliding else None, global_every=2 if sliding else 0,
        act_dtype=torch.float32, q_chunk=8,
    )
