"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 vocab=256000; RG-LRU recurrent blocks + local attention, pattern
(rec, rec, attn), window 2048. [arXiv:2402.19427; hf]

Bounded local-attention KV (``windowed_paged``) and O(1) LRU state
(``recurrent``) in one stack.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma_2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    d_inner=2560,  # LRU width
    ssm_conv=4,
    block_pattern=("rec", "rec", "attn"),
    sliding_window=2048,
    act_fn="gelu",
    norm="rms",
    rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="block",
    attn_chunk=2048,
    scan_layers=False,  # heterogeneous stack is unrolled (26 blocks)
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        d_inner=64,
        sliding_window=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
