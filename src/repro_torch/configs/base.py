"""Model configuration for the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig`` (same field
names and defaults, so an artifact manifest's ``model`` dict loads into it
unchanged) and of the architectures it serves. ``get_config(arch_id)`` is the
published configuration, ``get_smoke_config(arch_id)`` the reduced
same-family configuration the CPU tests use. ``SHAPES`` are the input-shape
cells (train, prefill, decode) that ``launch.specs`` sets up.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "get_smoke_config",
           "list_archs"]

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

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), JAX's formula:
        the roofline's model FLOPs and the dry run's FSDP choice read it."""
        d, v = self.d_model, self.vocab_padded
        emb = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        gate_mult = 3 if self.act_fn in ("silu", "gelu") else 2
        mlp = gate_mult * d * self.d_ff
        if self.family == "moe":
            mlp = self.n_experts * gate_mult * d * self.d_ff + d * self.n_experts
            mlp += self.n_shared_experts * gate_mult * d * self.shared_expert_d_ff
        if self.family == "ssm":
            di, n, r = self.d_inner, self.ssm_state, self.dt_rank
            per_layer = (d * 2 * di + di * (r + 2 * n) + r * di + di * d + di * self.ssm_conv
                         + di * n)
            return emb + self.n_layers * per_layer
        per_layer = attn + mlp
        if self.family == "hybrid":
            # recurrent and attention blocks; JAX's approximation of each
            di = self.d_inner or d
            rec = 2 * d * di + di * d + 3 * di * self.ssm_conv + 2 * di
            n_rec = sum(1 for b in self.expanded_pattern() if b == "rec")
            return emb + (self.n_layers - n_rec) * (attn + mlp) + n_rec * (rec + mlp)
        if self.family == "vlm" and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            per_layer_cross = attn + mlp + 2 * d  # gates
            return emb + (self.n_layers - n_cross) * per_layer + n_cross * per_layer_cross
        return emb + self.n_layers * per_layer

    @property
    def n_active_params(self) -> int:
        """Parameters a token passes through: ``n_params``, but for MoE only
        the routed experts' ``experts_per_token`` of ``n_experts``."""
        if self.family != "moe":
            return self.n_params
        d = self.d_model
        gate_mult = 3 if self.act_fn in ("silu", "gelu") else 2
        dense_side = self.n_params - self.n_layers * self.n_experts * gate_mult * d * self.d_ff
        return dense_side + self.n_layers * self.experts_per_token * gate_mult * d * self.d_ff

    def supports_long_context(self) -> bool:
        """True iff attention cost and memory are bounded (SSM, window, hybrid)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def expanded_pattern(self) -> tuple[str, ...]:
        """The block kind of every layer: ``block_pattern`` repeated to
        ``n_layers`` (the hybrid family's stack; empty otherwise)."""
        if not self.block_pattern:
            return ()
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_ARCHS = [
    "granite_moe_3b_a800m",
    "qwen2_moe_a2_7b",
    "h2o_danube_1_8b",
    "llama3_2_1b",
    "command_r_plus_104b",
    "nemotron_4_15b",
    "llama3_2_vision_11b",
    "falcon_mamba_7b",
    "musicgen_large",
    "recurrentgemma_2b",
    "oasis_7b",  # the paper's own LLaMA-7B-class evaluation model
]


def list_archs(assigned_only: bool = False) -> list[str]:
    """Every architecture, the JAX package's order; ``assigned_only`` leaves
    out the last, oasis (the paper's evaluation model)."""
    return _ARCHS[:-1] if assigned_only else list(_ARCHS)


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
