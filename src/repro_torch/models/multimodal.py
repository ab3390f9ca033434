"""Cross-attention vision-language decoder, llama3.2-vision's backbone (port
of ``repro/models/multimodal.py``).

40 blocks = 8 groups of (4 self-attention blocks + 1 gated cross-attention
block). The vision frontend is a stub, as in JAX: ``image_embeds`` arrive as
(B, n_img_tokens, d_model) patch embeddings. A :class:`CrossBlock` attends
from the text to them and gates both of its residual branches by a tanh of
a learned scalar (both zero at init: the identity).

:class:`VisionLM` holds the self blocks in one list (``self_blocks``, group
g's at ``g * n_self .. (g + 1) * n_self``) and the cross blocks in another
(``cross_blocks``), the names of JAX's tree, whose leaves stack them as
``(G, n_self, ...)`` and ``(G, ...)``. Its caches are one list in the order
the blocks run: per group its self blocks' ring dicts, then the group's
cross dict ``{"ck", "cv"}``, (B, n_img_tokens, KV, hd) bfloat16 zeros
whatever the ring's dtype. A cross cache is read, never written (JAX's
rule, ``layers.attention_apply``): so the served logits do not depend on the
image embeddings. The family exports no cache policies; the engine serves
it on the fixed-slot ring.
"""

from __future__ import annotations

import contextvars
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import transformer

__all__ = ["CrossBlock", "VisionLM", "groups", "init", "apply", "init_caches",
           "cache_policies"]


def groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, self blocks per group)."""
    per = cfg.cross_attn_every
    return cfg.n_layers // per, per - 1


class CrossBlock(nn.Module):
    """``x + attn(norm1(x), memory)`` (the attention gates its own output),
    then ``+ tanh(mlp_gate) * mlp(norm2(x))``."""

    def __init__(self, norm1, attn: L.Attention, norm2, mlp: L.MLP, mlp_gate,
                 norm1_bias=None, norm2_bias=None):
        super().__init__()
        par = transformer._param
        self.norm1, self.norm1_bias = par(norm1), par(norm1_bias)
        self.attn = attn
        self.norm2, self.norm2_bias = par(norm2), par(norm2_bias)
        self.mlp = mlp
        self.mlp_gate = par(mlp_gate)

    def forward(self, x, cfg: ModelConfig, positions, memory, cache):
        """-> (x, cache)."""
        a, cache = L.attention_apply(self.attn, L.norm_apply(self.norm1, x, cfg.norm,
                                                             self.norm1_bias), cfg,
                                     positions=positions, memory=memory, cache=cache,
                                     layer_tag="cross")
        x = x + a
        m = L.mlp_apply(self.mlp, L.norm_apply(self.norm2, x, cfg.norm, self.norm2_bias),
                        cfg.act_fn)
        x = x + torch.tanh(self.mlp_gate.to(m.dtype)) * m
        return constrain(x, "batch", "seq", "d_model"), cache


class VisionLM(nn.Module):
    """Embedding, ``self_blocks`` and ``cross_blocks`` run group by group,
    final norm and head."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, self_blocks: list,
                 cross_blocks: list, norm_f: torch.Tensor, head: nn.Module | None = None,
                 norm_f_bias: torch.Tensor | None = None):
        super().__init__()
        transformer.check_ported(cfg)
        n_groups, n_self = groups(cfg)
        if len(self_blocks) != n_groups * n_self or len(cross_blocks) != n_groups:
            raise ValueError(f"{cfg.arch_id} has {n_groups} groups of {n_self} self blocks "
                             "and one cross block")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.self_blocks = nn.ModuleList(self_blocks)
        self.cross_blocks = nn.ModuleList(cross_blocks)
        self.norm_f, self.norm_f_bias = transformer._param(norm_f), transformer._param(
            norm_f_bias)
        self.head = head

    def layers(self) -> list[nn.Module]:
        """Every block in the order they run (the caches' order)."""
        n_groups, n_self = groups(self.cfg)
        return [blk for g in range(n_groups)
                for blk in (*self.self_blocks[g * n_self : (g + 1) * n_self],
                            self.cross_blocks[g])]

    def _group(self, g: int, x, positions, memory, caches):
        """Group ``g``'s self blocks, then its cross block. -> (x, caches)."""
        cfg = self.cfg
        _, n_self = groups(cfg)
        out = []
        for j in range(n_self):
            x, c, _ = self.self_blocks[g * n_self + j](x, cfg, positions,
                                                       None if caches is None else caches[j])
            out.append(c)
        x, c = self.cross_blocks[g](x, cfg, positions, memory,
                                    None if caches is None else caches[n_self])
        return x, out + [c]

    def forward(self, tokens: torch.Tensor, image_embeds: torch.Tensor, positions=None,
                caches=None, last_only: bool = False, hidden_only: bool = False):
        """tokens (B, S), image_embeds (B, n_img_tokens, d) -> (float32
        logits (B, S, vocab_padded), or the final-norm hidden states with
        ``hidden_only``; caches). ``cfg.remat`` ``"block"`` or ``"double"``
        recomputes each group in the backward pass (JAX checkpoints its
        group body), in a copy of the forward's context, as
        ``TransformerLM`` does per block."""
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x = transformer.embed_in(self, tokens, positions)
        memory = constrain(image_embeds.to(x.dtype), "batch", None, "d_model")
        n_groups, n_self = groups(cfg)
        remat = (cfg.remat in ("block", "double") and caches is None
                 and torch.is_grad_enabled())
        new_caches = None if caches is None else []
        for g in range(n_groups):
            if remat:
                x, _ = checkpoint(contextvars.copy_context().run, self._group, g, x, positions,
                                  memory, None, use_reentrant=False)
                continue
            per = n_self + 1
            x, c = self._group(g, x, positions, memory,
                               None if caches is None else caches[g * per : (g + 1) * per])
            if caches is not None:
                new_caches += c
        return transformer.logits_out(self, x, last_only, hidden_only), new_caches


def init(cfg: ModelConfig, seed: int, device) -> VisionLM:
    """Seeded random init with the JAX package's scales (not its numbers);
    the two gates of every cross block start at zero, as in JAX."""
    transformer.check_ported(cfg)
    n_groups, n_self = groups(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dense = lambda d_in, d_out, scale=None: L.dense_init(gen, d_in, d_out, dtype, device, scale)
    zero = lambda: torch.zeros((), dtype=dtype, device=device)

    def attn(gate=None):
        return L.Attention(dense(d, h * hd), dense(d, kv * hd), dense(d, kv * hd),
                           dense(h * hd, d, 1.0 / math.sqrt(h * hd)), gate)

    embed = (torch.randn((cfg.vocab_padded, d), generator=gen, device=device) * 0.02).to(dtype)
    self_blocks = []
    for _ in range(n_groups * n_self):
        (n1, b1), (n2, b2) = (transformer._norm_init(cfg, dtype, device) for _ in range(2))
        self_blocks.append(transformer.Block(
            n1, attn(), L.mlp_init(gen, d, cfg.d_ff, cfg.act_fn, dtype, device), n2,
            norm1_bias=b1, norm2_bias=b2))
    cross_blocks = []
    for _ in range(n_groups):
        (n1, b1), (n2, b2) = (transformer._norm_init(cfg, dtype, device) for _ in range(2))
        cross_blocks.append(CrossBlock(n1, attn(zero()), n2,
                                       L.mlp_init(gen, d, cfg.d_ff, cfg.act_fn, dtype, device),
                                       zero(), b1, b2))
    head = None if cfg.tie_embeddings else dense(d, cfg.vocab_padded)
    nf, bf = transformer._norm_init(cfg, dtype, device)
    return VisionLM(cfg, embed, self_blocks, cross_blocks, nf, head, bf)


def apply(params: VisionLM, cfg: ModelConfig, tokens, *, image_embeds, positions=None,
          caches=None, last_only: bool = False, return_hidden_only: bool = False):
    """-> (logits, or the final-norm hidden states with
    ``return_hidden_only``, caches)."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    return params(tokens, image_embeds, positions=positions, caches=caches,
                  last_only=last_only, hidden_only=return_hidden_only)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                quantized: bool = False, layout: str = "ring", block_size: int = 16,
                n_blocks: int = 0, device="cpu") -> list[dict]:
    """Ring caches only (``layout="ring"``): per group, a ring of
    ``cache_len`` slots per self block (float in ``dtype``, or int4 K-Means
    with ``quantized``), then the cross cache, bfloat16 zeros of (batch,
    n_img_tokens, KV, hd)."""
    if layout != "ring":
        raise ValueError(f"the vlm family has only the ring layout, not {layout!r}")
    n_groups, n_self = groups(cfg)
    shape = (batch, cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim)
    out = []
    for _ in range(n_groups):
        out += [L.init_kv_cache(cfg, batch, cache_len, dtype, quantized, device)
                for _ in range(n_self)]
        out.append({k: torch.zeros(shape, dtype=torch.bfloat16, device=device)
                    for k in ("ck", "cv")})
    return out


def cache_policies(cfg: ModelConfig):
    """None: the family has no paged layout; the engine serves it on the
    fixed-slot ring."""
    return None
