"""Mamba-1 selective SSM decoder, falcon-mamba-7b (port of
``repro/models/mamba.py``).

Attention-free: each block is in_proj -> causal depthwise conv -> selective
SSM -> gated out_proj, held by a :class:`MambaBlock` in the port's
``TransformerLM`` container (embedding, blocks, final norm, head). The four
projections are ``Dense`` or ``QLinear`` modules; the recurrence is
elementwise and stays float32.

The recurrence ``h_t = a_t h_{t-1} + bx_t`` runs two ways, as in JAX:

* float state: :func:`_ssm_scan`, chunks of ``_CHUNK`` tokens, a log-step
  (Hillis-Steele) scan inside a chunk and a loop across chunks. JAX's
  ``associative_scan`` combines in another tree, so the two agree within
  float32 rounding of the sums, not bit for bit;
* int4 K-Means state: :func:`_ssm_scan_q`, one token at a time,
  requantizing the state after every token (``layers.state_quantize``), so
  position t's state depends only on the token stream. Its indices are the
  parity contract: given the same ``h0``, ``a``, ``bx`` and codebook they
  equal JAX's exactly.

Caches are slot-major state pools (``h`` or ``h_idx`` / ``h_scale`` /
``state_codebook``, and the float ``conv`` tail of ``ssm_conv - 1`` tokens),
the same in every layout, each the first rows of a storage with one
scratch slot after them (``layers.state_zeros``). Unlike JAX's functional
update the port writes them in place -- the ring branch copies the final
state over the pool, the packed branch scatters each row's final state to
its slot, rows with no valid cell to the scratch slot -- so the serving
steps keep their addresses and can be captured as CUDA graphs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.codebook import boundaries_from_centroids
from repro_torch.core.quantize import pack_int4
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import transformer

__all__ = ["MambaBlock", "init", "apply", "init_caches", "cache_policies", "block_apply",
           "softplus"]

_CHUNK = 128  # scan chunk of the float recurrence, JAX's

apply = transformer.apply


class MambaBlock(nn.Module):
    """One Mamba block's parameters, named as JAX's tree names them."""

    def __init__(self, norm, in_proj: nn.Module, conv_w, conv_b, x_proj: nn.Module,
                 dt_proj: nn.Module, dt_bias, A_log, D, out_proj: nn.Module, norm_bias=None):
        super().__init__()
        par = transformer._param
        self.norm, self.norm_bias = par(norm), par(norm_bias)
        self.in_proj, self.x_proj, self.dt_proj, self.out_proj = in_proj, x_proj, dt_proj, out_proj
        self.conv_w, self.conv_b = par(conv_w), par(conv_b)
        self.dt_bias, self.A_log, self.D = par(dt_bias), par(A_log), par(D)

    def forward(self, x, cfg: ModelConfig, positions, cache):
        """-> (x, cache, None): the ``Block`` interface (no aux loss)."""
        x, cache = block_apply(self, x, cfg, cache, positions)
        return x, cache, None


def _init_block(gen, cfg: ModelConfig, dtype, device) -> MambaBlock:
    """JAX's scales: S4D-real ``A``, ``dt`` log-uniform in [1e-3, 1e-1]
    behind an inverse softplus, ``D`` ones, a zero conv bias."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=device)[None, :].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dense = lambda d_in, d_out, **kw: L.dense_init(gen, d_in, d_out, dtype, device, **kw)
    norm, norm_bias = transformer._norm_init(cfg, dtype, device)
    conv_w = (torch.randn((cfg.ssm_conv, di), generator=gen, device=device)
              / math.sqrt(cfg.ssm_conv)).to(dtype)
    return MambaBlock(norm, dense(d, 2 * di), conv_w, torch.zeros((di,), dtype=dtype,
                                                                   device=device),
                      dense(di, r + 2 * n), dense(r, di, bias=True),
                      torch.log(torch.expm1(dt)), torch.log(a_init),
                      torch.ones((di,), dtype=torch.float32, device=device),
                      dense(di, d), norm_bias)


def init(cfg: ModelConfig, seed: int, device) -> transformer.TransformerLM:
    """Seeded random init with the JAX package's scales (not its numbers)."""
    transformer.check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    embed = (torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen, device=device)
             * 0.02).to(dtype)
    blocks = [_init_block(gen, cfg, dtype, device) for _ in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else L.dense_init(gen, cfg.d_model, cfg.vocab_padded,
                                                        dtype, device)
    nf, bf = transformer._norm_init(cfg, dtype, device)
    return transformer.TransformerLM(cfg, embed, blocks, nf, head, bf)


def state_cache(rows: int, width: int, n: int | None, cw: int, dtype, quantized: bool,
                device) -> dict:
    """One layer's state pools: ``h`` (rows, width, n) float32 (RG-LRU: n
    None, ``h`` (rows, width)) or its int4 K-Means form (``h_idx`` packed
    over the last dim, per-vector ``h_scale``, the structural 16-entry
    ``state_codebook``), and the float ``conv`` tail (rows, cw - 1, width)
    in ``dtype``, which is cw - 1 tokens and stays float."""
    from repro_torch.models.model import _default_codebook

    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    h = (width,) if n is None else (width, n)
    conv = L.state_zeros(rows, (cw - 1, width), dt, device)
    if not quantized:
        return {"h": L.state_zeros(rows, h, torch.float32, device), "conv": conv}
    return {"h_idx": L.state_zeros(rows, (*h[:-1], h[-1] // 2), torch.uint8, device),
            "h_scale": L.state_zeros(rows, (*h[:-1], 1), torch.float32, device),
            "conv": conv, "state_codebook": _default_codebook(4, device=device)}


def init_caches(cfg: ModelConfig, batch: int, cache_len: int = 0, dtype=torch.float32,
                quantized: bool = False, layout: str = "ring", block_size: int = 16,
                n_blocks: int = 0, device="cpu") -> list[dict]:
    """SSM state and conv tail per layer, slot-major in every layout
    (``cache_len``, ``block_size`` and ``n_blocks`` are unused: the state is
    O(1)); ``quantized`` gives the int4 K-Means state."""
    del cache_len, block_size, n_blocks
    if layout not in ("ring", "paged"):
        raise ValueError(f"unknown cache layout {layout!r} (ring or paged)")
    return [state_cache(batch, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, dtype, quantized,
                        device) for _ in range(cfg.n_layers)]


def cache_policies(cfg: ModelConfig):
    """Every Mamba block holds O(1) recurrent state: no KV blocks, one
    pinned state slot per request."""
    from repro_torch.serving.paged_cache import CachePolicy

    return [CachePolicy("recurrent")] * cfg.n_layers


# ---------------------------------------------------------------------------
# the pieces of a block
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` returns x past 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _conv_causal(x, w, b, tail=None):
    """Depthwise causal conv. x: (B, S, di); w: (cw, di); tail (B, cw-1, di).
    Returns (y, the new tail); the taps add in JAX's order."""
    cw = w.shape[0]
    pad = tail.to(x.dtype) if tail is not None else x.new_zeros((x.shape[0], cw - 1,
                                                                  x.shape[-1]))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, cw):
        y = y + xp[:, i : i + s] * w[i].to(x.dtype)
    new_tail = xp[:, -(cw - 1):] if cw > 1 else None
    return y + b.to(x.dtype), new_tail


def _ssm_scan(a, bx, h0):
    """Chunked linear recurrence. a, bx: (B, S, ...) float32; h0: (B, ...).
    Returns (hs (B, S, ...), h_S). ``S`` must be a multiple of
    ``min(_CHUNK, S)``, as JAX requires."""
    s = a.shape[1]
    chunk = min(_CHUNK, s)
    if s % chunk:
        raise ValueError(f"seq {s} must be divisible by scan chunk {chunk}")
    hs, h = [], h0
    for c0 in range(0, s, chunk):
        ac, bc = a[:, c0 : c0 + chunk], bx[:, c0 : c0 + chunk]
        step = 1
        while step < chunk:  # (a_l, b_l) then (a_r, b_r) -> (a_l a_r, b_l a_r + b_r)
            ar = ac[:, step:]
            bc = torch.cat([bc[:, :step], bc[:, :-step] * ar + bc[:, step:]], dim=1)
            ac = torch.cat([ac[:, :step], ac[:, :-step] * ar], dim=1)
            step *= 2
        hc = ac * h[:, None] + bc
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, dim=1), h


def _ssm_scan_q(a, bx, h0, codebook):
    """Sequential recurrence requantizing the state after every token: the
    carry entering step t is ``deq(quant(h_{t-1}))``. a, bx: (B, S, ...);
    h0 float (already dequantized). Returns (hs float per step, h_idx per
    step, h_scale per step); y reads the float pre-quantization hs.

    ``layers.state_quantize`` and ``state_dequantize`` per token, with the
    boundaries made once and the indices packed once after the loop (the
    carry dequantizes the unpacked indices): the same values in ten small
    ops a token instead of some twenty-five."""
    bounds = boundaries_from_centroids(codebook).contiguous()
    h, hs, idxs, scs = h0, [], [], []
    for t in range(a.shape[1]):
        hn = a[:, t] * h + bx[:, t]
        sc = torch.clamp(torch.sqrt(torch.mean(hn * hn, dim=-1, keepdim=True)), min=1e-12)
        idx = torch.searchsorted(bounds, (hn / sc).contiguous(), right=True, out_int32=True)
        h = codebook.index_select(0, idx.reshape(-1)).reshape(idx.shape) * sc
        hs.append(hn)
        idxs.append(idx)
        scs.append(sc)
    return torch.stack(hs, 1), pack_int4(torch.stack(idxs, 1)), torch.stack(scs, 1)


def _packed_conv_tails(tail0, xs, cw: int):
    """Per-cell conv tails of the packed layout. tail0 (G, cw-1, di), the
    tails gathered by slot; xs (G, S, di) the raw pre-conv inputs. Returns
    (G, S, cw-1, di): cell i holds the tail after tokens 0..i."""
    z = torch.cat([tail0.to(xs.dtype), xs], dim=1)
    idx = (torch.arange(xs.shape[1], device=xs.device)[:, None]
           + torch.arange(1, cw, device=xs.device)[None, :])
    return z[:, idx]


def _take_final(steps, n_valid):
    """steps (G, S, ...): each row's value at cell ``n_valid - 1`` (0 for a
    row with no valid cell, whose write goes to the scratch slot)."""
    i = torch.clamp(n_valid - 1, min=0)
    return steps[torch.arange(steps.shape[0], device=steps.device), i]


def gather_state(cache: dict, slots=None):
    """The layer's float32 state entering this call: dequantized for an int4
    pool; gathered by ``slots`` in the packed layout."""
    pick = (lambda t: t) if slots is None else (lambda t: t[slots])
    if "h_idx" in cache:
        return L.state_dequantize(pick(cache["h_idx"]), pick(cache["h_scale"]),
                                  cache["state_codebook"])
    return pick(cache["h"])


def write_state(cache: dict, new: dict, positions=None) -> dict:
    """Store a call's state in place. ``new`` maps each pool key (``h`` or
    ``h_idx`` / ``h_scale``, and ``conv``) to its per-cell steps (G, S, ...)
    in the packed layout -- each row's last valid cell goes to its slot
    (``token_slots``), a row with none to the scratch slot, and the steps
    come back as ``<key>_steps`` transients -- or to the final state in the
    ring layout, copied over the pool. Returns the cache dict."""
    if "token_slots" not in cache:
        for k, v in new.items():
            cache[k].copy_(v)
        return cache
    slots = cache["token_slots"].long()
    n_valid = (positions >= 0).sum(dim=1)
    n_slots = cache["conv"].shape[0]
    dest = torch.where(n_valid > 0, slots, n_slots)
    out = dict(cache)
    for k, steps in new.items():
        L.rows_with_scratch(cache[k]).index_copy_(0, dest,
                                                  _take_final(steps, n_valid).to(cache[k].dtype))
        out[f"{k}_steps"] = steps
    return out


def scan_state(a, bx, cache: dict | None, slots):
    """The recurrence over one call: h0 from the cache (zeros without one),
    the int4 scan for a quantized pool, else the chunked float scan.
    Returns (hs, the pool keys' new values: per-cell steps in the packed
    layout, final state otherwise)."""
    if cache is None:
        return _ssm_scan(a, bx, torch.zeros_like(bx[:, 0]))[0], {}
    h0 = gather_state(cache, slots)
    if "h_idx" in cache:
        hs, idx, sc = _ssm_scan_q(a, bx, h0, cache["state_codebook"])
        if slots is None:
            return hs, {"h_idx": idx[:, -1], "h_scale": sc[:, -1]}
        return hs, {"h_idx": idx, "h_scale": sc}
    hs, h_final = _ssm_scan(a, bx, h0)
    return hs, {"h": hs if slots is not None else h_final}


def conv_in(p, u, cfg: ModelConfig, cache: dict | None):
    """The causal conv over ``u`` with the cache's tail. Returns (conv out,
    slots (packed layout) or None, the ``conv`` pool's new value: the
    per-cell tails (packed) or the new tail)."""
    slots = None
    if cache is not None and "token_slots" in cache:
        slots = cache["token_slots"].long()
        tail0 = cache["conv"][slots]
        tails = _packed_conv_tails(tail0, u, cfg.ssm_conv).to(cache["conv"].dtype)
        y, _ = _conv_causal(u, p.conv_w, p.conv_b, tail0)
        return y, slots, tails
    y, new_tail = _conv_causal(u, p.conv_w, p.conv_b, None if cache is None else cache["conv"])
    return y, None, new_tail


def block_apply(p: MambaBlock, x, cfg: ModelConfig, cache, positions=None):
    """One Mamba block. x: (B, S, d). ``cache`` None (a full forward), the
    ring layout (the state pools of ``batch`` rows) or the packed serving
    layout (the slot-major pools plus ``token_slots`` (G,) and (G, S)
    positions with -1 marking pad cells; each slot in at most one row, its
    valid cells a contiguous prefix). Returns (x, cache); the packed layout's
    cache also carries the ``*_steps`` transients for the corrective commit
    (``paged_cache.split_step_extras``)."""
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    residual = x
    x = L.norm_apply(p.norm, x, cfg.norm, p.norm_bias)
    xz = L.dense_apply(p.in_proj, x, "mamba.in_proj")
    xs, z = xz[..., :di], xz[..., di:]
    xs = constrain(xs, "batch", "seq", "d_inner")
    xs, slots, conv_new = conv_in(p, xs, cfg, cache)
    xs = F.silu(xs)

    proj = L.dense_apply(p.x_proj, xs, "mamba.x_proj").float()
    dt, bmat, cmat = proj[..., :r], proj[..., r : r + n], proj[..., r + n :]
    dt = softplus(L.dense_apply(p.dt_proj, dt.to(xs.dtype), "mamba.dt_proj").float()
                  + p.dt_bias)  # (B, S, di)
    a = -torch.exp(p.A_log)  # (di, N)
    xf = xs.float()
    a_bar = torch.exp(dt[..., None] * a)  # (B, S, di, N)
    bx = (dt * xf)[..., None] * bmat[..., None, :]  # (B, S, di, N)
    hs, state_new = scan_state(a_bar, bx, cache, slots)
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat) + p.D * xf
    y = constrain(y.to(xs.dtype) * F.silu(z), "batch", "seq", "d_inner")
    out = L.dense_apply(p.out_proj, y, "mamba.out_proj")
    if cache is not None:
        cache = write_state(cache, state_new | {"conv": conv_new}, positions)
    return residual + out, cache
