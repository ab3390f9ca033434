"""h2o-danube-1.8b [dense] — 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
llama+mistral mix with sliding-window attention. [arXiv:2401.16818; hf]

SWA window 4096 bounds decode KV memory: the paged scheduler frees blocks
that fall wholly out of the window (the ``windowed_paged`` cache policy).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o_danube_1_8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    sliding_window=4096,
    act_fn="silu",
    norm="rms",
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
        sliding_window=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
