"""musicgen-large [audio] — 48L d=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048,
decoder-only over EnCodec tokens, sinusoidal positions, plain-GeLU FFN.
[arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is not modelled; the model consumes
discrete codec tokens (vocab 2048) directly, as the JAX package's config does.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen_large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    act_fn="gelu_plain",
    norm="layer",
    pos_embed="sinusoidal",
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
