"""Seeded float weights, made on the device in one call per stacked leaf.

``make(cfg, seed, device)`` returns a tree in the layer-stacked layout that
both sides read: the program builds its model from it
(``params_from_tree``) and quantizes it, the reference (``reference.py``)
quantizes it again itself. Every leaf is drawn in the dtype it is served in
(``torch_dtype``), the MoE router in float32 as the program keeps it. The
scales are the usual ``1 / sqrt(fan_in)`` (embedding 0.02); norm scales are
``1 + 0.1 n`` so that a lost norm scale shows. The same seed on the same
device gives the same tensors.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make", "vocab_padded"]


def vocab_padded(cfg: dict) -> int:
    """Embedding rows: the vocabulary padded to a multiple of 128."""
    return (cfg["vocab_size"] + 127) // 128 * 128


def make(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    dt = getattr(torch, cfg["torch_dtype"])
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    vp = vocab_padded(cfg)

    def randn(*shape, scale: float, dtype=dt) -> torch.Tensor:
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(scale)

    def norm(*shape) -> torch.Tensor:
        return randn(*shape, scale=0.1).add_(1.0)

    blocks = {
        "norm1": {"scale": norm(n, d)},
        "attn": {"wq": {"w": randn(n, d, h * hd, scale=d ** -0.5)},
                 "wk": {"w": randn(n, d, kv * hd, scale=d ** -0.5)},
                 "wv": {"w": randn(n, d, kv * hd, scale=d ** -0.5)},
                 "wo": {"w": randn(n, h * hd, d, scale=(h * hd) ** -0.5)}},
        "norm2": {"scale": norm(n, d)},
    }
    if cfg.get("num_local_experts"):
        e, f = cfg["num_local_experts"], cfg["intermediate_size"]
        blocks["moe"] = {"router": {"w": randn(n, d, e, scale=d ** -0.5, dtype=torch.float32)},
                         "wi": randn(n, e, d, 2 * f, scale=d ** -0.5),
                         "wd": randn(n, e, f, d, scale=f ** -0.5)}
    else:
        f = cfg["intermediate_size"]
        blocks["mlp"] = {"wi": {"w": randn(n, d, 2 * f, scale=d ** -0.5)},
                         "wd": {"w": randn(n, f, d, scale=f ** -0.5)}}
    tree = {"embed": {"table": randn(vp, d, scale=0.02)}, "blocks": blocks,
            "norm_f": {"scale": norm(d)}}
    if not cfg.get("tie_word_embeddings"):
        tree["head"] = {"w": randn(d, vp, scale=1 / math.sqrt(d))}
    return tree
