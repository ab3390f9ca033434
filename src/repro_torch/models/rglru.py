"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local MQA
attention, recurrentgemma-2b (port of ``repro/models/rglru.py``).

The block pattern (rec, rec, attn) repeats over the stack (26 layers = 8 x
(rec, rec, attn) + (rec, rec)). An attention layer is the transformer's
``Block`` under the config's sliding window; a recurrent layer is a
:class:`RecBlock`:

    r_t = sigmoid(W_a u_t + b_a)          recurrence gate
    i_t = sigmoid(W_x u_t + b_x)          input gate
    a_t = exp(c r_t log(sigmoid(L)))      c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

elementwise over the LRU width, through the Mamba module's scans (float
chunks, or int4 state requantized every token) with state size 1. The
caches are heterogeneous: slot-major state pools (``mamba.state_cache``)
for recurrent layers in every layout, and for attention layers a ring
clamped to the window or a share of the paged pool, whose out-of-window
blocks the scheduler frees (the ``windowed_paged`` policy).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import mamba, transformer

__all__ = ["RecBlock", "init", "apply", "init_caches", "cache_policies", "rglru_gates",
           "rec_block_apply"]

_C_RGLRU = 8.0

apply = transformer.apply


class RecBlock(nn.Module):
    """One RG-LRU block's parameters, named as JAX's tree names them."""

    def __init__(self, norm1, lin_y: nn.Module, lin_x: nn.Module, conv_w, conv_b,
                 w_a: nn.Module, w_x: nn.Module, lam, lin_out: nn.Module, norm2,
                 mlp: L.MLP, norm1_bias=None, norm2_bias=None):
        super().__init__()
        par = transformer._param
        self.norm1, self.norm1_bias = par(norm1), par(norm1_bias)
        self.norm2, self.norm2_bias = par(norm2), par(norm2_bias)
        self.lin_y, self.lin_x, self.lin_out = lin_y, lin_x, lin_out
        self.w_a, self.w_x = w_a, w_x
        self.conv_w, self.conv_b = par(conv_w), par(conv_b)
        self.lam = par(lam)  # JAX's "lambda"
        self.mlp = mlp

    def forward(self, x, cfg: ModelConfig, positions, cache):
        """-> (x, cache, None): the ``Block`` interface (no aux loss)."""
        x, cache = rec_block_apply(self, x, cfg, cache, positions)
        return x, cache, None


def _init_rec_block(gen, cfg: ModelConfig, dtype, device) -> RecBlock:
    d, di = cfg.d_model, cfg.d_inner or cfg.d_model
    dense = lambda d_in, d_out, **kw: L.dense_init(gen, d_in, d_out, dtype, device, **kw)
    n1, b1 = transformer._norm_init(cfg, dtype, device)
    n2, b2 = transformer._norm_init(cfg, dtype, device)
    lin_y, lin_x = dense(d, di), dense(d, di)
    conv_w = (torch.randn((cfg.ssm_conv, di), generator=gen, device=device)
              / math.sqrt(cfg.ssm_conv)).to(dtype)
    w_a, w_x = dense(di, di, bias=True), dense(di, di, bias=True)
    lam = torch.full((di,), 2.0, dtype=torch.float32, device=device)  # sigmoid: a ~ 0.88
    return RecBlock(n1, lin_y, lin_x, conv_w, torch.zeros((di,), dtype=dtype, device=device),
                    w_a, w_x, lam, dense(di, d), n2,
                    L.mlp_init(gen, d, cfg.d_ff, cfg.act_fn, dtype, device), b1, b2)


def _init_attn_block(gen, cfg: ModelConfig, dtype, device) -> transformer.Block:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dense = lambda d_in, d_out, scale=None: L.dense_init(gen, d_in, d_out, dtype, device, scale)
    attn = L.Attention(dense(d, h * hd), dense(d, kv * hd), dense(d, kv * hd),
                       dense(h * hd, d, 1.0 / math.sqrt(h * hd)))
    n1, b1 = transformer._norm_init(cfg, dtype, device)
    n2, b2 = transformer._norm_init(cfg, dtype, device)
    return transformer.Block(n1, attn, L.mlp_init(gen, d, cfg.d_ff, cfg.act_fn, dtype, device),
                             n2, norm1_bias=b1, norm2_bias=b2)


def init(cfg: ModelConfig, seed: int, device) -> transformer.TransformerLM:
    """Seeded random init with the JAX package's scales (not its numbers)."""
    transformer.check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    embed = (torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, device=device)
             * 0.02).to(dtype)
    blocks = [_init_rec_block(gen, cfg, dtype, device) if kind == "rec"
              else _init_attn_block(gen, cfg, dtype, device)
              for kind in cfg.expanded_pattern()]
    head = None if cfg.tie_embeddings else L.dense_init(gen, cfg.d_model, cfg.vocab_padded,
                                                        dtype, device)
    nf, bf = transformer._norm_init(cfg, dtype, device)
    return transformer.TransformerLM(cfg, embed, blocks, nf, head, bf)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, dtype=torch.bfloat16,
                quantized: bool = False, layout: str = "ring", block_size: int = 16,
                n_blocks: int = 0, device="cpu") -> list[dict]:
    """Recurrent layers: slot-major state in every layout (``quantized``:
    int4 K-Means ``h``). Attention layers: a ring of ``min(cache_len,
    window)`` slots (``layout="ring"``) or the paged pool of ``n_blocks``
    blocks (0: ``batch * ceil(cache_len / block_size)``) with logical tables
    (``layout="paged"``)."""
    di = cfg.d_inner or cfg.d_model
    if layout == "paged":
        if n_blocks <= 0:
            n_blocks = batch * -(-cache_len // block_size)
        attn_one = lambda: L.init_paged_kv_cache(cfg, n_blocks, block_size, dtype, quantized,
                                                 device)
    elif layout == "ring":
        kv_len = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
        attn_one = lambda: L.init_kv_cache(cfg, batch, kv_len, dtype, quantized, device)
    else:
        raise ValueError(f"unknown cache layout {layout!r} (ring or paged)")
    return [mamba.state_cache(batch, di, None, cfg.ssm_conv, dtype, quantized, device)
            if kind == "rec" else attn_one() for kind in cfg.expanded_pattern()]


def cache_policies(cfg: ModelConfig):
    """Per layer, following the pattern: rec -> ``recurrent``, attn ->
    ``windowed_paged`` at the window (``paged_kv`` if a config clears it)."""
    from repro_torch.serving.paged_cache import CachePolicy

    attn = (CachePolicy("windowed_paged", window=cfg.sliding_window) if cfg.sliding_window
            else CachePolicy("paged_kv"))
    rec = CachePolicy("recurrent")
    return [rec if kind == "rec" else attn for kind in cfg.expanded_pattern()]


def rglru_gates(p: RecBlock, u: torch.Tensor):
    """u (B, S, di) after the conv -> (a_t, gated input), both float32."""
    uf = u.float()
    r = torch.sigmoid(L.dense_apply(p.w_a, u, "rglru.wa").float())
    i = torch.sigmoid(L.dense_apply(p.w_x, u, "rglru.wx").float())
    log_a = -mamba.softplus(-p.lam)  # jax.nn.log_sigmoid, < 0
    a = torch.exp(_C_RGLRU * r * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9)) * (i * uf)
    return a, gated


def rec_block_apply(p: RecBlock, x, cfg: ModelConfig, cache, positions=None):
    """One RG-LRU block, in the layouts of ``mamba.block_apply`` (no cache,
    ring, packed with ``*_steps`` transients). Returns (x, cache)."""
    residual = x
    n = L.norm_apply(p.norm1, x, cfg.norm, p.norm1_bias)
    y = F.gelu(L.dense_apply(p.lin_y, n, "rec.lin_y"), approximate="tanh")
    u = constrain(L.dense_apply(p.lin_x, n, "rec.lin_x"), "batch", "seq", "d_inner")
    u, slots, conv_new = mamba.conv_in(p, u, cfg, cache)
    a, gated = rglru_gates(p, u)
    hs, state_new = mamba.scan_state(a, gated, cache, slots)
    u = hs.to(u.dtype)
    out = L.dense_apply(p.lin_out, y * u, "rec.lin_out")
    x = residual + out
    x = x + L.mlp_apply(p.mlp, L.norm_apply(p.norm2, x, cfg.norm, p.norm2_bias), cfg.act_fn)
    if cache is not None:
        cache = mamba.write_state(cache, state_new | {"conv": conv_new}, positions)
    return constrain(x, "batch", "seq_sp", "d_model"), cache
