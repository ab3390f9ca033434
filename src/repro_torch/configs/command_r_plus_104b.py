"""command-r-plus-104b [dense] — 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000. Parallel attention+FFN blocks, LayerNorm, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="command_r_plus_104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33_792,
    vocab_size=256_000,
    head_dim=128,
    parallel_blocks=True,
    act_fn="silu",
    norm="layer",
    rope_theta=75_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="double",
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
