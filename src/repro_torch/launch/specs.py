"""Per-cell setup for the dry run (port of ``repro/launch/specs.py``): the
step function, its arguments as fake tensors and their sharding specs, for
every (arch x shape x mesh) combination.

``make_rules`` sets a cell's logical-axis -> mesh-axis map with the
per-architecture divisibility fallbacks, and ``input_specs`` gives shape and
dtype records for every model input of a cell. ``build_cell`` makes the
arguments under ``FakeTensorMode`` (the counterpart of ``jax.eval_shape``:
nothing is allocated), so the full configurations exist only here.

Shape kinds set up different entry points:
  train_*   -> the train step (float params + AdamW state, microbatches)
  prefill_* -> the prefill step (quantized params: the paper's serving path)
  decode_* / long_* -> the serve step (one new token against a seq_len cache)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.core.qlinear import QLinearConfig
from repro_torch.core.quantspec import QuantSpec
from repro_torch.distributed.param_sharding import (build_cache_specs, build_param_specs,
                                                    cache_tree)
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import MODEL_AXIS_SIZE, batch_axes_for
from repro_torch.launch.roofline import HW
from repro_torch.models.model import build, quantize_model, tree_from_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.engine import ServeConfig, make_prefill_step, make_serve_step
from repro_torch.train.trainer import (TrainConfig, init_train_state, make_train_step,
                                       train_state_tree)

__all__ = ["CellSetup", "TensorSpec", "make_rules", "build_cell", "input_specs", "runnable",
           "skip_reason"]


@dataclasses.dataclass
class CellSetup:
    arch: str
    shape: str
    multi_pod: bool
    step_fn: Callable
    args: tuple  # the step's arguments, fake tensors (a module holds the params)
    in_specs: tuple  # PartitionSpec trees in JAX's layout, one per argument
    rules: dict
    cfg: ModelConfig
    meta: dict


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


def _batch_pspec(batch_specs: dict, batch_axes) -> dict:
    return {k: P(batch_axes, *([None] * (len(v.shape) - 1))) for k, v in batch_specs.items()}


def _fake_inputs(specs: dict[str, TensorSpec]) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in specs.items()}


def build_cell(arch: str, shape_name: str, multi_pod: bool, quantized_serving: bool = True,
               kv_quant: bool = False, overrides: dict | None = None,
               hbm_bytes: float = HW().hbm_bytes, smoke: bool = False) -> CellSetup:
    """The cell's step, fake arguments (on the CPU) and specs, branch for
    branch JAX's ``build_cell``. ``hbm_bytes``: the card whose half the
    trained state may fill before FSDP shards it over the batch axes (JAX
    takes half of a 16 GB TPU; the default is the H100's 80 GB).
    ``smoke``: the architecture's smoke configuration (the shape's batch
    and length kept), for quick checks of the tooling."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(f"cell ({arch}, {shape_name}) skipped: {reason}")
    model = build(cfg)
    shards = _batch_shards(multi_pod)
    batch_shardable = shape.global_batch % shards == 0
    # Megatron SP for wide-activation training cells (residual stream sharded
    # on "model"), where activations dominate memory
    seq_parallel = shape.kind == "train" and cfg.d_model >= 4096
    rules = make_rules(cfg, multi_pod, batch_shardable, seq_parallel=seq_parallel,
                       seq_len=shape.seq_len)
    batch_axes = rules["batch"]
    batch_specs = input_specs(cfg, shape)
    batch_pspec = _batch_pspec(batch_specs, batch_axes)
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    if shape.kind == "train":
        # microbatches trade activation memory against gradient-reduction
        # traffic, which grows linearly with them
        max_micro = 4 if cfg.n_params > 50e9 else 8
        micro = max(1, min(max_micro, shape.global_batch // shards))
        tc = TrainConfig(optimizer=AdamWConfig(), microbatches=micro)
        with fake:
            state = init_train_state(model, 0, tc, device="cpu")
            batch = _fake_inputs(batch_specs)
        # ZeRO-3 / FSDP when the TP-sharded state (bf16 params + 2 float32
        # moments + float32 grads = 14 B a parameter) would fill half the card
        fsdp = None
        if cfg.n_params * 14 / MODEL_AXIS_SIZE > hbm_bytes / 2 and batch_shardable:
            fsdp = batch_axes
        kw = dict(fsdp_axes=fsdp, fsdp_shards=shards if fsdp else 1)
        tree = train_state_tree(state)
        specs = lambda t: build_param_specs(t, MODEL_AXIS_SIZE, **kw)
        state_specs = {"params": specs(tree["params"]),
                       "opt": {"m": specs(tree["opt"]["m"]), "v": specs(tree["opt"]["v"]),
                               "step": P()}}
        return CellSetup(
            arch, shape_name, multi_pod, step_fn=make_train_step(model, tc),
            args=(state, batch), in_specs=(state_specs, batch_pspec), rules=rules, cfg=cfg,
            meta={"kind": "train", "microbatches": micro,
                  "tokens": shape.global_batch * shape.seq_len},
        )

    # ---- serving cells -----------------------------------------------------
    # decode: dynamic Orizuru detection (a one-token sort is cheap); prefill:
    # static thresholds with dense masked compensation (a sort over 32k-token
    # activations would cost far more workspace)
    spec = QuantSpec(base=QLinearConfig(
        outlier_frac=0.005,
        detection="dynamic" if shape.kind == "decode" else "static_dense",
        compute_dtype=getattr(torch, cfg.compute_dtype),
    ))
    sc = ServeConfig(cache_len=shape.seq_len, kv_quant=kv_quant)
    with fake:
        params = model.init(0, device="cpu")
        if quantized_serving:
            params = quantize_model(model, params, spec, shapes_only=True)
        caches = model.init_caches(shape.global_batch, shape.seq_len, torch.bfloat16,
                                   kv_quant, device="cpu")
        batch = _fake_inputs(batch_specs)
        pos = torch.zeros((), dtype=torch.int32)
    pspecs = build_param_specs(tree_from_params(params), MODEL_AXIS_SIZE)
    cspecs = build_cache_specs(cache_tree(caches, cfg), batch_axes, shards, MODEL_AXIS_SIZE,
                               kv_heads=cfg.n_kv_heads, ssm_state=cfg.ssm_state)
    if shape.kind == "prefill":
        return CellSetup(
            arch, shape_name, multi_pod, step_fn=make_prefill_step(model, sc),
            args=(params, caches, batch), in_specs=(pspecs, cspecs, batch_pspec),
            rules=rules, cfg=cfg,
            meta={"kind": "prefill", "quantized": quantized_serving,
                  "tokens": shape.global_batch * shape.seq_len},
        )
    return CellSetup(
        arch, shape_name, multi_pod, step_fn=make_serve_step(model, sc),
        args=(params, caches, batch["tokens"], pos),
        in_specs=(pspecs, cspecs, P(batch_axes, None), P()), rules=rules, cfg=cfg,
        meta={"kind": "decode", "quantized": quantized_serving, "kv_quant": kv_quant,
              "tokens": shape.global_batch},
    )
