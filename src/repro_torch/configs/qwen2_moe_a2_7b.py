"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) d_ff=1408/expert,
vocab=151936, 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2_moe_a2_7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    n_experts=60,
    experts_per_token=4,
    n_shared_experts=4,
    shared_expert_d_ff=1408,
    act_fn="silu",
    norm="rms",
    rope_theta=1_000_000.0,
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
        n_kv_heads=4,
        head_dim=16,
        d_ff=64,
        vocab_size=256,
        n_experts=8,
        experts_per_token=2,
        n_shared_experts=2,
        shared_expert_d_ff=64,
        capacity_factor=2.0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
