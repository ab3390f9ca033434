"""AdamW and the cosine schedule (port of ``repro/optim/adamw.py``).

A parameter tree here is a flat mapping ``{name: tensor}`` (the trainer
passes the model's ``named_parameters``). Moments are float32 whatever the
parameter dtype; the update is computed in float32 and cast back to the
parameter's dtype, as in JAX. The update runs in place (parameters and
moments keep their storage), and reads nothing back to the host: the clip
scale and the gradient norm stay device tensors.

Weight decay applies to matrices only. JAX decides by the rank of the leaf
in its own tree, where a scanned stack gives every per-layer vector a
leading layer axis: pass ``decay={name: bool}`` to decide by that rank
(``train.trainer.decay_mask``); without it the tensor's own rank decides.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import numpy as np
import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0  # 0 disables clipping


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], torch.Tensor]:
    """Linear warm-up, then a cosine decay to ``min_frac * base_lr``; a
    float32 scalar, computed in float32 as JAX computes it."""

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)

    return lr


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": {k: zeros32(p) for k, p in params.items()},
            "v": {k: zeros32(p) for k, p in params.items()},
            "step": 0}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: dict,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig, lr,
                 decay: Mapping[str, bool] | None = None):
    """One AdamW step, in place. Returns (params, opt_state, {"grad_norm"})."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm > 0:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    step = opt_state["step"] + 1
    t = np.float32(step)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
    lr = float(lr)
    for k, p in params.items():
        gf = grads[k].float()
        if scale is not None:
            gf = gf * scale
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * gf)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(gf))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if (p.ndim >= 2 if decay is None else decay[k]) and cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm}
