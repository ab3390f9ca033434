"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

40 experts, top-8, as the JAX package's config sets them.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite_moe_3b_a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    n_experts=40,
    experts_per_token=8,
    act_fn="silu",
    norm="rms",
    tie_embeddings=True,
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
        d_ff=64,
        vocab_size=256,
        n_experts=8,
        experts_per_token=2,
        capacity_factor=2.0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
