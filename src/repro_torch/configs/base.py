"""Model configuration for the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig`` (same field
names and defaults, so an artifact manifest's ``model`` dict loads into it
unchanged) and of the architectures it serves. ``get_config(arch_id)`` is the
published configuration, ``get_smoke_config(arch_id)`` the reduced
same-family configuration the CPU tests use.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs"]

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description (field-for-field the JAX config)."""

    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    act_fn: str = "silu"
    norm: str = "rms"
    parallel_blocks: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    sliding_window: int = 0

    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 32

    d_inner: int = 0
    ssm_state: int = 16
    ssm_conv: int = 4
    dt_rank: int = 0
    block_pattern: tuple[str, ...] = ()

    cross_attn_every: int = 0
    n_img_tokens: int = 0

    input_mode: str = "tokens"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    scan_layers: bool = True
    remat: str = "none"
    attn_chunk: int = 0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 128 (the embedding table's rows)."""
        return (self.vocab_size + 127) // 128 * 128


_ARCHS = ["llama3_2_1b", "oasis_7b"]


def list_archs() -> list[str]:
    return list(_ARCHS)


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"arch '{arch_id}' is not ported yet; ported: {_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
