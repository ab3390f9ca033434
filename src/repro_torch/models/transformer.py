"""Dense decoder-only transformer LM (port of ``repro/models/transformer.py``).

``TransformerLM`` holds its layers in an ``nn.ModuleList`` where the JAX
package scans over stacked parameters. The paged serving caches are a list
of per-layer pool dicts.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

__all__ = ["Block", "TransformerLM", "check_ported", "init", "apply", "init_caches",
           "cache_policies"]


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm1(x))``, then ``+ mlp(norm2(x))``."""

    def __init__(self, norm1, attn: L.Attention, mlp: L.MLP, norm2):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.attn, self.mlp = attn, mlp
        self.norm2 = nn.Parameter(norm2, requires_grad=False)

    def forward(self, x, cfg: ModelConfig, positions, cache):
        a, cache = L.attention_apply(self.attn, L.norm_apply(self.norm1, x), cfg,
                                     positions=positions, cache=cache,
                                     window=cfg.sliding_window)
        x = x + a
        return x + L.mlp_apply(self.mlp, L.norm_apply(self.norm2, x)), cache


def check_ported(cfg: ModelConfig) -> None:
    """The dense RMSNorm / SwiGLU / RoPE LLaMA shape is what is ported."""
    ported = (cfg.family == "dense" and cfg.norm == "rms" and cfg.act_fn == "silu"
              and cfg.pos_embed == "rope" and not cfg.parallel_blocks)
    if not ported:
        raise NotImplementedError(f"config {cfg.arch_id} needs model features that are "
                                  "not ported yet (only dense RMSNorm/SwiGLU/RoPE blocks)")


class TransformerLM(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and (tied or own) head."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, blocks: list[Block],
                 norm_f: torch.Tensor, head: nn.Module | None = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.norm_f = nn.Parameter(norm_f, requires_grad=False)
        self.head = head

    def forward(self, tokens: torch.Tensor, positions=None, caches=None,
                last_only: bool = False):
        """tokens (B, S) -> (logits float32 (B, S, vocab_padded), caches)."""
        cfg = self.cfg
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x = self.embed[tokens.long()].to(getattr(torch, cfg.compute_dtype))
        new_caches = None if caches is None else []
        for i, block in enumerate(self.blocks):
            x, c = block(x, cfg, positions, None if caches is None else caches[i])
            if caches is not None:
                new_caches.append(c)
        if last_only:
            x = x[:, -1:]
        x = L.norm_apply(self.norm_f, x)
        if cfg.tie_embeddings:
            logits = x @ self.embed.to(x.dtype).T
        else:
            logits = L.dense_apply(self.head, x)
        return logits.float(), new_caches


def init(cfg: ModelConfig, seed: int, device) -> TransformerLM:
    """Seeded random init with the JAX package's scales (not its numbers:
    ``torch.Generator`` and ``jax.random`` draw different streams)."""
    check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ones = lambda: torch.ones((d,), dtype=dtype, device=device)

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, dtype, device, scale)

    embed = (torch.randn((cfg.vocab_padded, d), generator=gen, device=device) * 0.02).to(dtype)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = L.Attention(dense(d, h * hd), dense(d, kv * hd), dense(d, kv * hd),
                           dense(h * hd, d, 1.0 / math.sqrt(h * hd)))
        mlp = L.MLP(dense(d, 2 * cfg.d_ff), dense(cfg.d_ff, d, 1.0 / math.sqrt(cfg.d_ff)))
        blocks.append(Block(ones(), attn, mlp, ones()))
    head = None if cfg.tie_embeddings else dense(d, cfg.vocab_padded)
    return TransformerLM(cfg, embed, blocks, ones(), head)


def apply(params: TransformerLM, cfg: ModelConfig, tokens, *, positions=None, caches=None,
          last_only: bool = False):
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(tokens, positions=positions, caches=caches, last_only=last_only)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                quantized: bool = False, block_size: int = 16, n_blocks: int = 0,
                device="cpu") -> list[dict]:
    """Per-layer slices of the global paged pool (``batch * ceil(cache_len /
    block_size)`` blocks when ``n_blocks`` is 0): float pages in ``dtype``, or
    int4 K-Means pages with ``quantized``. The ring layout waits."""
    if n_blocks <= 0:
        n_blocks = batch * -(-cache_len // block_size)
    return [L.init_paged_kv_cache(cfg, n_blocks, block_size, dtype, quantized, device)
            for _ in range(cfg.n_layers)]


def cache_policies(cfg: ModelConfig):
    """Every dense block is paged KV (sliding-window policies wait)."""
    from repro_torch.serving.paged_cache import CachePolicy

    if cfg.sliding_window:
        raise NotImplementedError("the windowed_paged cache policy is not ported yet")
    return [CachePolicy("paged_kv")] * cfg.n_layers
