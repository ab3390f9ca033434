"""Per-cell sharding rules and input specs (port of the rules half of
``repro/launch/specs.py``).

``make_rules`` sets a cell's logical-axis -> mesh-axis map with the
per-architecture divisibility fallbacks, and ``input_specs`` gives shape and
dtype records for every model input of a cell; nothing is allocated.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import MODEL_AXIS_SIZE, batch_axes_for

__all__ = ["TensorSpec", "make_rules", "input_specs", "runnable", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a model input (JAX's ``ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def make_rules(cfg: ModelConfig, multi_pod: bool, batch_shardable: bool = True,
               seq_parallel: bool = False, seq_len: int = 0) -> dict:
    """Logical-axis -> mesh-axis map with per-arch divisibility fallbacks.

    ``seq_parallel=True`` shards the residual-stream seq dim on "model"
    (Megatron SP): norms and residuals run on seq shards, with an all-gather
    before attention / MLP and a reduce-scatter after."""
    m = MODEL_AXIS_SIZE
    batch = batch_axes_for(multi_pod) if batch_shardable else None
    fits = lambda dim: (dim or 0) % m == 0 and dim
    return {
        "batch": batch,
        "seq": None,
        "seq_sp": "model" if (seq_parallel and fits(seq_len)) else None,
        "d_model": None,
        "heads_flat": "model" if fits(cfg.n_heads * cfg.head_dim) else None,
        "kv_heads": "model" if fits(cfg.n_kv_heads) else None,
        "d_ff": "model" if fits(cfg.d_ff) else None,
        "vocab": "model",  # vocab_padded is always a multiple of 128
        "experts": "model" if fits(cfg.n_experts) else None,
        "dispatch_groups": batch,  # group-local MoE dispatch follows DP
        "d_inner": "model" if fits(cfg.d_inner) else None,
        "state": None,
    }


def runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return skip_reason(cfg, shape) is None


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return (
            "pure full-attention arch: 500k decode requires sub-quadratic "
            "attention (DESIGN.md §5); run only for SSM/SWA/hybrid"
        )
    return None


def _batch_shards(multi_pod: bool) -> int:
    return 32 if multi_pod else 16


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, TensorSpec]:
    """Shape and dtype of the model inputs of one cell (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {"tokens": TensorSpec((b, s + 1), torch.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": TensorSpec((b, s), torch.int32)}
    else:  # decode: one new token, cache of length s
        out = {"tokens": TensorSpec((b, 1), torch.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = TensorSpec((b, cfg.n_img_tokens, cfg.d_model),
                                         getattr(torch, cfg.compute_dtype))
    return out
