"""llama-3.2-vision-11b [vlm] — 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; every 5th block is a gated cross-attention block over image
patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend (ViT + projector) is a stub: callers pass precomputed
(B, 1601, d_model) patch embeddings as ``image_embeds``; the serving engine
passes zeros.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3_2_vision_11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    head_dim=128,
    cross_attn_every=5,
    n_img_tokens=1601,
    input_mode="tokens+image",
    act_fn="silu",
    norm="rms",
    rope_theta=500_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="block",
    attn_chunk=2048,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        cross_attn_every=2,
        n_img_tokens=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        attn_chunk=0,
    )
