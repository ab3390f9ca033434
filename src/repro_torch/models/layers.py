"""Building blocks of the dense decoder (port of ``repro/models/layers.py``).

Every projection is either a :class:`Dense` (float weight ``(K, N)``) or a
:class:`~repro_torch.core.qlinear.QLinear`; :func:`dense_apply` calls either.
Attention is ported on two branches: no cache (training / full-sequence
logits) and the paged KV pool of the serving scheduler -- int4 K-Means or
float (bfloat16 / float32) pages -- where ``_paged_write`` stores this call's
keys and values and ``_paged_attend`` runs the pool's paged-attention kernel
wrapper. The pools are updated in place (``index_copy_``): PyTorch tensors
are mutable, and a functional copy of a full-width pool per layer per step
would double its memory traffic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.codebook import assign_via_boundaries
from repro_torch.core.qlinear import QLinear
from repro_torch.core.quantize import pack_int4
from repro_torch.kernels.paged_attn import paged_attn_bf16, paged_attn_int4

__all__ = [
    "Dense",
    "dense_apply",
    "norm_apply",
    "rope_apply",
    "Attention",
    "MLP",
    "init_paged_kv_cache",
    "attention_apply",
    "mlp_apply",
]

_NEG_INF = torch.finfo(torch.float32).min


class Dense(nn.Module):
    """Float projection ``y = x @ w (+ b)`` with ``w`` of shape ``(K, N)``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


def dense_apply(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Float or quantized projection (a :class:`Dense` or a :class:`QLinear`)."""
    if not isinstance(p, (Dense, QLinear)):
        raise TypeError(f"not a projection module: {type(p).__name__}")
    return p(x)


def norm_apply(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 (LayerNorm configs are not ported yet)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, ..., hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions.float()[..., None] * freq
    ang = ang.reshape(*positions.shape, *([1] * (x.ndim - 3)), half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module, wo: nn.Module):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


class MLP(nn.Module):
    def __init__(self, wi: nn.Module, wd: nn.Module):
        super().__init__()
        self.wi, self.wd = wi, wd


# ---------------------------------------------------------------------------
# no-cache attention
# ---------------------------------------------------------------------------

def _sdpa_dense(q, k, v, q_pos, k_pos, window: int, softcap: float) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = (k_pos >= 0)[None, :] & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def init_paged_kv_cache(cfg, n_blocks: int, block_size: int, dtype=torch.bfloat16,
                        quantized: bool = False,
                        device: torch.device | str = "cpu") -> dict:
    """One layer's slice of the global block pool: ``pages_k`` / ``pages_v``
    (n_blocks, block_size, KV, hd) in ``dtype`` (a torch dtype or its name),
    or with ``quantized`` int4 K-Means blocks with per-(token, head) scales."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    if not quantized:
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        shape = (n_blocks, block_size, kv, hd)
        return {"pages_k": torch.zeros(shape, dtype=dt, device=device),
                "pages_v": torch.zeros(shape, dtype=dt, device=device)}
    from repro_torch.models.model import _default_codebook

    u8 = dict(dtype=torch.uint8, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "pages_k_idx": torch.zeros((n_blocks, block_size, kv, hd // 2), **u8),
        "pages_v_idx": torch.zeros((n_blocks, block_size, kv, hd // 2), **u8),
        "pages_k_scale": torch.zeros((n_blocks, block_size, kv, 1), **f32),
        "pages_v_scale": torch.zeros((n_blocks, block_size, kv, 1), **f32),
        "kv_codebook": _default_codebook(4, device=device),
    }


def _kv_quantize(x: torch.Tensor, codebook: torch.Tensor):
    """x: (B, T, KV, hd) -> (packed idx uint8, per-(token, head) scale f32)."""
    xf = x.float()
    s = torch.clamp(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True)), min=1e-12)
    idx = assign_via_boundaries((x / s).float(), codebook)
    return pack_int4(idx), s


def _paged_write(cache: dict, k, v, positions, ctx_lens) -> dict:
    """Store this call's tokens in their pool slots, in place.

    A token is written iff ``0 <= position < ctx_lens[b]`` and its table
    entry is allocated; the others (padding, idle rows) are filtered out
    before the copy, as JAX drops them with an out-of-bounds index."""
    quantized = "pages_k_idx" in cache
    pages = cache["pages_k_idx"] if quantized else cache["pages_k"]
    n_blocks, bs = pages.shape[0], pages.shape[1]
    bt = cache["block_tables"]
    blk = torch.clamp(positions // bs, 0, bt.shape[1] - 1).long()
    block_id = torch.gather(bt, 1, blk)
    valid = (positions >= 0) & (positions < ctx_lens[:, None]) & (block_id >= 0)
    dest = (block_id.long() * bs + positions % bs)[valid]
    if quantized:
        ki, ks = _kv_quantize(k, cache["kv_codebook"])
        vi, vs = _kv_quantize(v, cache["kv_codebook"])
        writes = (("pages_k_idx", ki), ("pages_v_idx", vi),
                  ("pages_k_scale", ks), ("pages_v_scale", vs))
    else:
        writes = (("pages_k", k.to(pages.dtype)), ("pages_v", v.to(pages.dtype)))
    for key, vals in writes:
        pool = cache[key]
        flat = pool.view(n_blocks * bs, *pool.shape[2:])
        flat.index_copy_(0, dest, vals[valid])
    return cache


def _paged_attend(cache: dict, q, q_pos, softcap: float, window: int = 0) -> torch.Tensor:
    """Attention against the block pool through the block table."""
    qf, qp = q.float().contiguous(), q_pos.int().contiguous()
    bt = cache["block_tables"].contiguous()
    if "pages_k_idx" in cache:
        o = paged_attn_int4(qf, cache["pages_k_idx"], cache["pages_k_scale"],
                            cache["pages_v_idx"], cache["pages_v_scale"], cache["kv_codebook"],
                            bt, cache["ctx_lens"], qp, softcap=softcap, window=window)
    else:
        o = paged_attn_bf16(qf, cache["pages_k"], cache["pages_v"], bt, cache["ctx_lens"], qp,
                            softcap=softcap, window=window)
    return o.to(q.dtype)


def attention_apply(p: Attention, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                    cache: dict | None = None, window: int = 0):
    """GQA attention. Returns (out, cache).

    ``positions``: (S,) shared (no cache) or (B, S) per row (paged serving,
    -1 = padded cell). A paged cache may carry ``token_slots`` (B,): the
    packed layout, where the tables are per scheduler slot and each row is a
    segment of slot ``token_slots[b]``.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    softcap = cfg.logit_softcap

    q = dense_apply(p.wq, x).reshape(b, s, kv, g, hd)
    k = dense_apply(p.wk, x).reshape(b, s, kv, hd)
    v = dense_apply(p.wv, x).reshape(b, s, kv, hd)
    if cfg.pos_embed == "rope":
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)

    if cache is not None and "block_tables" in cache:
        if "token_slots" in cache:
            cache = cache | {"block_tables": cache["block_tables"][cache["token_slots"].long()]}
        q_pos = positions if positions.ndim == 2 else positions.expand(b, s)
        cache = _paged_write(cache, k, v, q_pos, cache["ctx_lens"])
        o = _paged_attend(cache, q, q_pos, softcap, window)
    elif cache is None:
        o = _sdpa_dense(q, k, v, positions, positions, window, softcap)
    else:
        raise NotImplementedError("the ring-buffer KV cache is not ported yet")
    out = dense_apply(p.wo, o.reshape(b, s, h * hd))
    return out, cache


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP with the fused ``[gate; up]`` projection."""
    gate, up = torch.chunk(dense_apply(p.wi, x), 2, dim=-1)
    return dense_apply(p.wd, F.silu(gate) * up)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> Dense:
    """Seeded normal init, ``1/sqrt(d_in)`` by default (the JAX scheme)."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device) * s
    return Dense(w.to(dtype))
