"""oasis-7b — the paper's own evaluation model class (LLaMA-7B: 32L d=4096
32H MHA d_ff=11008 vocab=32000). Used for the paper-faithful benchmarks
(Table I/III analogs, Fig. 14/16) and as the K=4096, N=4096 GEMM reference.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="oasis_7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11_008,
    vocab_size=32_000,
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
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
