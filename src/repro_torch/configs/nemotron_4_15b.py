"""nemotron-4-15b [dense] — 32L d=6144 48H (GQA kv=8) d_ff=24576 vocab=256000,
squared-ReLU MLP (no gating), LayerNorm. [arXiv:2402.16819; unverified]

Squared-ReLU activations are one-sided heavy-tailed — the outlier-compensation
branch of the paper's technique is especially relevant here.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron_4_15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=128,
    act_fn="relu2",
    norm="layer",
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="block",
    attn_chunk=2048,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
