"""falcon-mamba-7b [ssm] — 64L d=4096 attention-free Mamba-1, ssm_state=16,
vocab=65024. [arXiv:2410.05355; unverified]

O(1) decode state: the ``recurrent`` cache policy holds one slot of state
per request and no KV blocks.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65_024,
    d_inner=8192,
    ssm_state=16,
    ssm_conv=4,
    dt_rank=256,
    norm="rms",
    pos_embed="none",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat="block",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG,
        n_layers=2,
        d_model=64,
        vocab_size=256,
        d_inner=128,
        ssm_state=4,
        ssm_conv=4,
        dt_rank=8,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
