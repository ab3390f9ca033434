"""Decoder-only transformer LM (port of ``repro/models/transformer.py``).

Covers llama3.2-1b, h2o-danube (sliding-window attention), command-r-plus
(parallel attention + FFN blocks, LayerNorm), nemotron-4 (squared ReLU,
LayerNorm) and the musicgen backbone (sinusoidal positions, plain GeLU);
``models/moe.py`` builds its blocks on the same stack, and
``TransformerLM`` is also the container of the Mamba (``models/mamba.py``)
and RG-LRU hybrid (``models/rglru.py``) stacks. The vlm family
(``models/multimodal.py``) shares its embedding and head (:func:`embed_in`,
:func:`logits_out`).

``TransformerLM`` holds its layers in an ``nn.ModuleList`` where the JAX
package scans over stacked parameters. The serving caches (ring buffers or
paged pools) are a list of per-layer dicts.
"""

from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, gather_dim
from repro_torch.models import layers as L
from repro_torch.serving.telemetry import region

__all__ = ["Block", "TransformerLM", "check_ported", "init", "apply", "init_caches",
           "cache_policies", "embed_in", "logits_out"]

PORTED_FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")


def _param(t: torch.Tensor | None) -> nn.Parameter | None:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """Pre-norm block. Sequential: ``x + attn(norm1(x))``, then ``+
    ffn(norm2(x))``, the FFN an ``mlp`` or (moe family) a ``moe``.
    Parallel (``cfg.parallel_blocks``, no ``norm2``): ``(x + attn(n)) +
    mlp(n)`` with ``n = norm1(x)``, JAX's order of the two adds. ``norm*``
    are the norms' scales; LayerNorm configs add ``norm*_bias``."""

    def __init__(self, norm1, attn: L.Attention, mlp: nn.Module | None = None,
                 norm2=None, *, norm1_bias=None, norm2_bias=None, moe: nn.Module | None = None):
        super().__init__()
        self.norm1, self.norm1_bias = _param(norm1), _param(norm1_bias)
        self.attn = attn
        self.mlp, self.moe = mlp, moe
        self.norm2, self.norm2_bias = _param(norm2), _param(norm2_bias)

    def forward(self, x, cfg: ModelConfig, positions, cache):
        """-> (x, cache, the MoE layer's aux loss or None)."""
        n = L.norm_apply(self.norm1, x, cfg.norm, self.norm1_bias)
        a, cache = L.attention_apply(self.attn, n, cfg, positions=positions, cache=cache,
                                     window=cfg.sliding_window)
        aux = None
        if cfg.parallel_blocks:
            x = x + a + L.mlp_apply(self.mlp, n, cfg.act_fn)
        else:
            x = x + a
            n = L.norm_apply(self.norm2, x, cfg.norm, self.norm2_bias)
            if self.moe is not None:
                m, aux = self.moe(n, cfg)
                x = x + m
            else:
                x = x + L.mlp_apply(self.mlp, n, cfg.act_fn)
        return constrain(x, "batch", "seq_sp", "d_model"), cache, aux


def check_ported(cfg: ModelConfig) -> None:
    """Every family of the JAX package is ported; refused are the norms,
    positions and activations neither package has, and configs no model of
    the family can take (a vlm without its groups of self blocks and one
    cross block)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"config {cfg.arch_id}: the {cfg.family} family is not "
                                  f"ported yet (ported: {', '.join(PORTED_FAMILIES)})")
    if cfg.norm not in ("rms", "layer") or cfg.pos_embed not in ("rope", "sinusoidal", "none") \
            or cfg.act_fn not in (*L.GATED_ACTS, "relu2", "gelu_plain"):
        raise NotImplementedError(f"config {cfg.arch_id}: norm {cfg.norm!r}, positions "
                                  f"{cfg.pos_embed!r} or activation {cfg.act_fn!r} is not "
                                  "ported")
    if cfg.family == "moe" and cfg.parallel_blocks:
        raise NotImplementedError("parallel MoE blocks exist in neither package")
    if cfg.family == "vlm" and (cfg.cross_attn_every < 2 or cfg.n_layers % cfg.cross_attn_every
                                or cfg.n_img_tokens < 1):
        raise NotImplementedError(f"config {cfg.arch_id}: a vlm needs n_layers in groups of "
                                  "cross_attn_every >= 2 blocks (self blocks, then one cross "
                                  "block) and image tokens; no such vlm exists in either package")


class TransformerLM(nn.Module):
    """Embedding (plus sinusoidal positions when the config asks), ``n_layers``
    blocks, final norm and (tied or own) head."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor, blocks: list[nn.Module],
                 norm_f: torch.Tensor, head: nn.Module | None = None,
                 norm_f_bias: torch.Tensor | None = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.norm_f, self.norm_f_bias = _param(norm_f), _param(norm_f_bias)
        self.head = head

    def forward(self, tokens: torch.Tensor, positions=None, caches=None,
                last_only: bool = False, hidden_only: bool = False):
        """tokens (B, S) -> (logits float32 (B, S, vocab_padded), caches, the
        sum of the MoE layers' aux losses or None). ``hidden_only`` returns
        the final-norm hidden states (B, S, d) in place of the logits.

        Without caches and with autograd on, ``cfg.remat`` ``"block"`` or
        ``"double"`` recomputes each block in the backward pass
        (``torch.utils.checkpoint``), as JAX checkpoints its block. The
        recompute runs in a copy of the forward's context, so calibration's
        taps read there what they read in the forward, also on the thread
        that runs the backward."""
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        x = embed_in(self, tokens, positions)
        remat = (cfg.remat in ("block", "double") and caches is None
                 and torch.is_grad_enabled())
        new_caches = None if caches is None else []
        aux_total = None
        for i, block in enumerate(self.blocks):
            if remat:
                x, c, aux = checkpoint(contextvars.copy_context().run, block, x, cfg, positions,
                                       None, use_reentrant=False)
            else:
                x, c, aux = block(x, cfg, positions, None if caches is None else caches[i])
            if caches is not None:
                new_caches.append(c)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return logits_out(self, x, last_only, hidden_only), new_caches, aux_total


def embed_in(lm: nn.Module, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The embedding of ``tokens`` (B, S) in the compute dtype, plus the
    sinusoidal positions where the config asks."""
    cfg = lm.cfg
    # on DTensors: DTensor's masked lookup into a vocab-sharded table and
    # the backward of an index (``index_put``) on sharded tokens both fail,
    # so the table's vocab is gathered and the lookup is ``F.embedding``
    table = gather_dim(lm.embed, 0)
    x = F.embedding(tokens.long(), table).to(getattr(torch, cfg.compute_dtype))
    if cfg.pos_embed == "sinusoidal":
        pe = L.sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        x = x + (pe if positions.ndim == 2 else pe[None])
    return constrain(x, "batch", "seq_sp", "d_model")


def logits_out(lm: nn.Module, x: torch.Tensor, last_only: bool, hidden_only: bool):
    """The final norm, then (unless ``hidden_only``) the float32 logits
    through the tied embedding or the head; ``last_only`` keeps the last
    position. Both are the region ``head`` (``serving.telemetry.region``)."""
    if last_only:
        x = x[:, -1:]
    region("head")
    x = L.norm_apply(lm.norm_f, x, lm.cfg.norm, lm.norm_f_bias)
    if hidden_only:
        region("other")
        return x
    if lm.cfg.tie_embeddings:
        logits = x @ lm.embed.to(x.dtype).T
    else:
        logits = L.dense_apply(lm.head, x)
    logits = constrain(logits.float(), "batch", "seq", "vocab")
    region("other")
    return logits


def _norm_init(cfg: ModelConfig, dtype, device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(scale, bias): ones, and zeros for LayerNorm."""
    d = cfg.d_model
    bias = torch.zeros((d,), dtype=dtype, device=device) if cfg.norm == "layer" else None
    return torch.ones((d,), dtype=dtype, device=device), bias


def init(cfg: ModelConfig, seed: int, device, ffn=None) -> TransformerLM:
    """Seeded random init with the JAX package's scales (not its numbers:
    ``torch.Generator`` and ``jax.random`` draw different streams).
    ``ffn(gen, dtype)`` makes a block's MoE FFN (``models/moe.py``); by
    default each block gets an MLP."""
    check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(d_in, d_out, scale=None):
        return L.dense_init(gen, d_in, d_out, dtype, device, scale)

    embed = (torch.randn((cfg.vocab_padded, d), generator=gen, device=device) * 0.02).to(dtype)
    blocks = []
    for _ in range(cfg.n_layers):
        attn = L.Attention(dense(d, h * hd), dense(d, kv * hd), dense(d, kv * hd),
                           dense(h * hd, d, 1.0 / math.sqrt(h * hd)))
        n1, b1 = _norm_init(cfg, dtype, device)
        n2, b2 = (None, None) if cfg.parallel_blocks else _norm_init(cfg, dtype, device)
        if ffn is not None:
            blocks.append(Block(n1, attn, None, n2, norm1_bias=b1, norm2_bias=b2,
                                moe=ffn(gen, dtype)))
        else:
            mlp = L.mlp_init(gen, d, cfg.d_ff, cfg.act_fn, dtype, device)
            blocks.append(Block(n1, attn, mlp, n2, norm1_bias=b1, norm2_bias=b2))
    head = None if cfg.tie_embeddings else dense(d, cfg.vocab_padded)
    nf, bf = _norm_init(cfg, dtype, device)
    return TransformerLM(cfg, embed, blocks, nf, head, bf)


def apply(params: TransformerLM, cfg: ModelConfig, tokens, *, positions=None, caches=None,
          last_only: bool = False, return_hidden_only: bool = False):
    """-> (logits, or the final-norm hidden states with
    ``return_hidden_only``, caches)."""
    if params.cfg != cfg:
        raise ValueError("params were built for another config")
    out, caches, _ = params(tokens, positions=positions, caches=caches, last_only=last_only,
                            hidden_only=return_hidden_only)
    return out, caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                quantized: bool = False, layout: str = "ring", block_size: int = 16,
                n_blocks: int = 0, device="cpu") -> list[dict]:
    """Per-layer KV caches, float in ``dtype`` or int4 K-Means with
    ``quantized``.

    ``layout="ring"`` (the default, as in JAX): a ring buffer of
    ``cache_len`` slots per request row (``layers.init_kv_cache``); a
    sliding-window config clamps ``cache_len`` to its window.
    ``layout="paged"``: per-layer slices of the global block pool
    (``layers.init_paged_kv_cache``), ``batch * ceil(cache_len /
    block_size)`` blocks when ``n_blocks`` is 0; the scheduler attaches the
    tables per call. Sliding-window configs use the same pool with logical
    tables (position p always at ``table[p // block_size]``); the scheduler
    frees entries that fall wholly out of the window."""
    if layout == "paged":
        if n_blocks <= 0:
            n_blocks = batch * -(-cache_len // block_size)
        return [L.init_paged_kv_cache(cfg, n_blocks, block_size, dtype, quantized, device)
                for _ in range(cfg.n_layers)]
    if layout != "ring":
        raise ValueError(f"unknown cache layout {layout!r} (ring or paged)")
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)
    return [L.init_kv_cache(cfg, batch, cache_len, dtype, quantized, device)
            for _ in range(cfg.n_layers)]


def cache_policies(cfg: ModelConfig):
    """Every block is paged KV; sliding-window configs get the windowed
    variant, whose out-of-window blocks the scheduler frees (at most
    ``ceil(window / block_size) + 1`` live per request in steady state)."""
    from repro_torch.serving.paged_cache import CachePolicy

    if cfg.sliding_window:
        return [CachePolicy("windowed_paged", window=cfg.sliding_window)] * cfg.n_layers
    return [CachePolicy("paged_kv")] * cfg.n_layers
