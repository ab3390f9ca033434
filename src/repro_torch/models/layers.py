"""Building blocks of the decoders (port of ``repro/models/layers.py``).

Every projection is either a :class:`Dense` (float weight ``(K, N)``) or a
:class:`~repro_torch.core.qlinear.QLinear`; :func:`dense_apply` calls either.
Norms are RMSNorm or LayerNorm, reduced in float32 (:func:`norm_apply`);
positions are rotary (in attention) or sinusoidal (added to the embedding,
:func:`sinusoidal_positions`); the MLP's activation is gated SiLU or GeLU,
squared ReLU or plain GeLU (:func:`act_apply`, GeLU in JAX's tanh form).
Attention runs on three branches, and a fourth for cross-attention over a
memory (the vlm family's image embeddings: no RoPE, no mask, K/V from the
memory or read from a filled cross cache):

* no cache (training / full-sequence logits): ``_attn_dispatch`` takes the
  dense softmax, or ``_sdpa_flash`` -- an online-softmax loop over query and
  key chunks in plain PyTorch, as JAX computes it outside any kernel -- once
  ``Sq * Sk`` passes 2048^2 and the config sets ``attn_chunk``;
* the ring-buffer cache of the fixed-slot engine (``init_kv_cache``): float
  or int4 K-Means slots per request row, written at ``(start + i) % C`` by
  ``_cache_write`` and read back whole by ``_cache_read``, then the same
  dispatch with the per-row ``pad_len`` masking a left-padded prompt's pad
  keys;
* the paged KV pool of the serving scheduler -- int4 K-Means or float
  (bfloat16 / float32) pages -- where ``_paged_write`` stores this call's
  keys and values and ``_paged_attend`` runs the pool's paged-attention
  kernel wrapper (or its plain version under ``REPRO_PAGED_KERNEL=0``).

Both caches are updated in place (``index_copy_``): PyTorch tensors are
mutable, and a functional copy of a full-width cache per layer per step
would double its memory traffic. Nothing on the paged branch or on the
ring's decode branch reads a tensor on the host or copies one from it, so
the serving scheduler and the fixed-slot engine can capture their steps as
CUDA graphs.

Activations carry logical axes through ``distributed.sharding.constrain``
at JAX's sites: the identity unless a rule set is active and the tensor is
a DTensor (the sharded train step).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import calibration, numerics
from repro_torch.core import kernel_routing as kr
from repro_torch.core.codebook import assign_via_boundaries
from repro_torch.core.qlinear import QLinear
from repro_torch.core.quantize import pack_int4, unpack_int4
from repro_torch.distributed.sharding import constrain, gather_dim, run_local
from repro_torch.kernels.paged_attn import (paged_attn_bf16, paged_attn_int4,
                                            paged_attn_plain, paged_attn_quant_plain)
from repro_torch.serving.telemetry import region

__all__ = [
    "Dense",
    "dense_apply",
    "norm_apply",
    "sinusoidal_positions",
    "rope_apply",
    "Attention",
    "MLP",
    "init_kv_cache",
    "init_paged_kv_cache",
    "state_zeros",
    "rows_with_scratch",
    "state_quantize",
    "state_dequantize",
    "attention_apply",
    "act_apply",
    "mlp_apply",
    "mlp_init",
]

_NEG_INF = torch.finfo(torch.float32).min
# the dims of q (B, S, KV, G, hd) and k, v (B, S, KV, hd) along which
# attention is independent: a sharded step attends on each rank's own rows
# and KV heads (DTensor's einsum cannot flatten a sharded batch dim with a
# sharded head dim)
_ROW_AND_HEAD = (0, 2)


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


def dense_apply(p: nn.Module, x: torch.Tensor, tap_name: str | None = None) -> torch.Tensor:
    """Float or quantized projection (a :class:`Dense` or a :class:`QLinear`).
    ``tap_name`` is the projection's calibration tap (``calibration.tap``:
    an identity outside a capture or a Fisher pass) and names a quantized
    projection's probe site, which does nothing outside ``numerics.collect``."""
    if tap_name is not None:
        x = calibration.tap(tap_name, x)
    if isinstance(p, QLinear):
        numerics.announce(tap_name)
    elif not isinstance(p, Dense):
        raise TypeError(f"not a projection module: {type(p).__name__}")
    return p(x)


def norm_apply(scale: torch.Tensor, x: torch.Tensor, kind: str = "rms",
               bias: torch.Tensor | None = None, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``kind="rms"``) or LayerNorm (``"layer"``: mean and variance,
    then scale and ``bias``), reduced in float32 whatever x's dtype, as JAX
    reduces them (``F.layer_norm`` on a bfloat16 input would not).

    A DTensor holding partial sums (a row-parallel projection added into the
    residual) is reduced here, Megatron's all-reduce: DTensor would carry
    them through the norm and then replicate the next projection's weight
    to multiply the partial activations whole on every rank."""
    if isinstance(x, DTensor) and any(pl.is_partial() for pl in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if pl.is_partial() else pl
                                           for pl in x.placements])
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    elif kind == "layer":
        xc = xf - torch.mean(xf, dim=-1, keepdim=True)
        y = xc * torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    y = y * scale.float()
    if kind == "layer":
        y = y + bias.float()
    return y.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The classic sinusoidal embedding, ``[sin | cos]`` halves, (..., d)
    float32 for positions of any shape (-1 marks a padded cell; its row is
    finite and unused)."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, ..., hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    # theta filled on the device: a host tensor here would be copied to the
    # card on every call, which a captured step does not allow
    freq = torch.pow(torch.full((), theta, dtype=torch.float32, device=x.device), exps)
    ang = positions.float()[..., None] * freq
    ang = ang.reshape(*positions.shape, *([1] * (x.ndim - 3)), half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


class Attention(nn.Module):
    """The four projections; a gated cross-attention (llama3.2-vision) adds
    its scalar ``gate``, whose tanh scales the output."""

    def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module, wo: nn.Module,
                 gate: torch.Tensor | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.gate = None if gate is None else nn.Parameter(gate, requires_grad=False)


class MLP(nn.Module):
    def __init__(self, wi: nn.Module, wd: nn.Module):
        super().__init__()
        self.wi, self.wd = wi, wd


# ---------------------------------------------------------------------------
# no-cache attention
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, window: int, causal: bool) -> torch.Tensor:
    """(Sq, Sk) bool validity mask; ``k_pos == -1`` marks empty cache slots."""
    valid = (k_pos >= 0)[None, :]
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    return valid


def _mask_scores(s, msk, k_pos, k_min) -> torch.Tensor:
    """Apply an (Sq, Sk) mask to scores s (B, KV, G, Sq, Sk). ``k_min`` (B,)
    also masks keys at positions below ``k_min[b]`` per row: the pad tokens a
    left-padded prompt wrote at positions [0, pad_len)."""
    neg = torch.full((), _NEG_INF, dtype=s.dtype, device=s.device)
    if k_min is not None:
        mb = msk[None] & (k_pos[None, None, :] >= k_min[:, None, None])  # (B, Sq, Sk)
        return torch.where(mb[:, None, None], s, neg)
    return torch.where(msk, s, neg)


def _sdpa_dense(q, k, v, q_pos, k_pos, window: int, causal: bool, softcap: float,
                k_min=None) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = _mask_scores(s, _mask(q_pos, k_pos, window, causal), k_pos, k_min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, v.float()).to(q.dtype)


def _sdpa_flash(q, k, v, q_pos, k_pos, window: int, causal: bool, softcap: float,
                q_chunk: int, k_chunk: int, k_min=None) -> torch.Tensor:
    """Online-softmax attention over query and key chunks, JAX's nested
    scan as two Python loops: the scores buffer is (B, KV, G, q_chunk,
    k_chunk) instead of (.., Sq, Sk). The tails are padded to whole chunks
    as JAX pads them (query rows at position 0, discarded; keys at position
    -1, masked)."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    pq, pk = (-sq) % q_chunk, (-sk) % k_chunk
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=0)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_pos = F.pad(k_pos, (0, pk), value=-1)
    scale = hd ** -0.5
    outs = []
    for i in range(0, sq + pq, q_chunk):
        qf, qp = q[:, i : i + q_chunk].float(), q_pos[i : i + q_chunk]
        m = torch.full((b, kvh, g, q_chunk), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), dtype=torch.float32, device=q.device)
        for j in range(0, sk + pk, k_chunk):
            kp = k_pos[j : j + k_chunk]
            s = torch.einsum("bskgh,btkh->bkgst", qf, k[:, j : j + k_chunk].float()) * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            s = _mask_scores(s, _mask(qp, kp, window, causal), kp, k_min)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh", p,
                                                        v[:, j : j + k_chunk].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def _attn_dispatch(q, k, v, q_pos, k_pos, window: int, causal: bool, softcap: float, cfg,
                   k_min=None) -> torch.Tensor:
    """The flash loop once ``Sq * Sk`` passes 2048^2 and the config sets
    ``attn_chunk`` (both chunks that long), else the dense softmax."""
    if cfg.attn_chunk > 0 and q.shape[1] * k.shape[1] > 4_194_304:
        return _sdpa_flash(q, k, v, q_pos, k_pos, window, causal, softcap,
                           cfg.attn_chunk, cfg.attn_chunk, k_min=k_min)
    return _sdpa_dense(q, k, v, q_pos, k_pos, window, causal, softcap, k_min=k_min)


# ---------------------------------------------------------------------------
# ring-buffer KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                  quantized: bool = False, device: torch.device | str = "cpu") -> dict:
    """Ring-buffer KV cache of one attention layer: ``slot_pos`` (C,) holds
    the absolute position stored in each slot (-1 = empty); ``k`` / ``v``
    (batch, C, KV, hd) in ``dtype``, or with ``quantized`` int4 K-Means
    ``k_idx`` / ``v_idx`` (two indices per byte) with per-(token, head)
    float32 scales and the structural 16-entry codebook."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    base = {"slot_pos": torch.full((cache_len,), -1, dtype=torch.int32, device=device)}
    zeros = lambda last, dt: torch.zeros((batch, cache_len, kv, last), dtype=dt, device=device)
    if not quantized:
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return base | {"k": zeros(hd, dt), "v": zeros(hd, dt)}
    from repro_torch.models.model import _default_codebook

    return base | {
        "k_idx": zeros(hd // 2, torch.uint8),
        "v_idx": zeros(hd // 2, torch.uint8),
        "k_scale": zeros(1, torch.float32),
        "v_scale": zeros(1, torch.float32),
        "kv_codebook": _default_codebook(4, device=device),
    }


# ---------------------------------------------------------------------------
# paged KV pool
# ---------------------------------------------------------------------------

def init_paged_kv_cache(cfg, n_blocks: int, block_size: int, dtype=torch.bfloat16,
                        quantized: bool = False,
                        device: torch.device | str = "cpu") -> dict:
    """One layer's slice of the global block pool: ``pages_k`` / ``pages_v``
    (n_blocks, block_size, KV, hd) in ``dtype`` (a torch dtype or its name),
    or with ``quantized`` int4 K-Means blocks with per-(token, head) scales.

    Each page array is the first ``n_blocks`` blocks of a storage of
    ``n_blocks + 1``: the block after them is the scratch block where
    ``_paged_write`` sends the cells it must not store. No table entry can
    name it, so it never aliases a real block."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim

    def pages(last: int, dt) -> torch.Tensor:
        store = torch.zeros((n_blocks + 1, block_size, kv, last), dtype=dt, device=device)
        return store[:n_blocks]

    if not quantized:
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return {"pages_k": pages(hd, dt), "pages_v": pages(hd, dt)}
    from repro_torch.models.model import _default_codebook

    return {
        "pages_k_idx": pages(hd // 2, torch.uint8),
        "pages_v_idx": pages(hd // 2, torch.uint8),
        "pages_k_scale": pages(1, torch.float32),
        "pages_v_scale": pages(1, torch.float32),
        "kv_codebook": _default_codebook(4, device=device),
    }


def _cells_with_scratch(pool: torch.Tensor) -> torch.Tensor:
    """``pool`` (n_blocks, bs, ...) as ``(n_blocks + 1) * bs`` cells: its own
    cells, then the scratch block's, which lies past the pages in their
    storage (``init_paged_kv_cache``)."""
    n_blocks, bs = pool.shape[:2]
    cell = math.prod(pool.shape[2:])
    held = pool.untyped_storage().nbytes() // pool.element_size() - pool.storage_offset()
    if not pool.is_contiguous() or held < (n_blocks + 1) * bs * cell:
        raise ValueError("a paged pool needs the scratch block after its pages: "
                         "make it with init_paged_kv_cache")
    return pool.as_strided(((n_blocks + 1) * bs, *pool.shape[2:]), pool.stride()[1:])


def _kv_quantize(x: torch.Tensor, codebook: torch.Tensor):
    """x: (B, T, KV, hd) -> (packed idx uint8, per-(token, head) scale f32)."""
    xf = x.float()
    s = torch.clamp(torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True)), min=1e-12)
    idx = assign_via_boundaries((x / s).float(), codebook)
    return pack_int4(idx), s


def _kv_dequantize(packed: torch.Tensor, scale: torch.Tensor, codebook: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (codebook[unpack_int4(packed).long()] * scale).to(dtype)


# ---------------------------------------------------------------------------
# recurrent state (the ssm and hybrid families)
# ---------------------------------------------------------------------------

def state_zeros(rows: int, shape: tuple, dtype, device) -> torch.Tensor:
    """A zero state pool of ``rows`` slots: the first ``rows`` rows of a
    storage of ``rows + 1``. The row after them is the scratch slot where a
    packed step sends the states of rows with no valid cell
    (:func:`rows_with_scratch`), as JAX drops them; no slot id names it."""
    return torch.zeros((rows + 1, *shape), dtype=dtype, device=device)[:rows]


def rows_with_scratch(pool: torch.Tensor) -> torch.Tensor:
    """``pool`` (rows, ...) as ``rows + 1`` rows: its own, then the scratch
    slot that lies past them in their storage (:func:`state_zeros`)."""
    rows = pool.shape[0]
    row = math.prod(pool.shape[1:])
    held = pool.untyped_storage().nbytes() // pool.element_size() - pool.storage_offset()
    if not pool.is_contiguous() or held < (rows + 1) * row:
        raise ValueError("a state pool needs the scratch slot after its rows: make it "
                         "with state_zeros")
    return pool.as_strided((rows + 1, *pool.shape[1:]), pool.stride())


def state_quantize(x: torch.Tensor, codebook: torch.Tensor):
    """Recurrent-state int4 quantization (Mamba ``h`` (B, di, N), RG-LRU
    ``h`` (B, di)): per-vector RMS scale over the last dim and K-Means
    boundary assignment, the KV pool's format. Returns (packed idx uint8,
    scale float32); the last dim must be even."""
    return _kv_quantize(x, codebook)


def state_dequantize(packed: torch.Tensor, scale: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`state_quantize`; the recurrence runs in float32."""
    return _kv_dequantize(packed, scale, codebook, torch.float32)


def _cache_write(cache: dict, k, v, positions: torch.Tensor) -> dict:
    """Store the last ``n_w = min(S, C)`` tokens in their ring slots, in
    place: position ``p`` lives in slot ``p % C``. One ``index_copy_`` of a
    fixed shape per tensor, at ``(start + arange(n_w)) % C`` with ``start``
    a device tensor, so a decode step reads nothing on the host. This is
    JAX's ``dynamic_update_slice`` (and its ``roll`` when ``n_w == C``) under
    the same contract: ``positions`` (S,) contiguous ascending, multi-token
    writes ring-aligned (prefill from position 0)."""
    c = cache["slot_pos"].shape[0]
    n_w = min(k.shape[1], c)
    pos_w = positions[-n_w:]
    slots = (pos_w[0] % c + torch.arange(n_w, device=pos_w.device)) % c
    if "k_idx" in cache:
        ki, ks = _kv_quantize(k[:, -n_w:], cache["kv_codebook"])
        vi, vs = _kv_quantize(v[:, -n_w:], cache["kv_codebook"])
        writes = (("k_idx", ki), ("v_idx", vi), ("k_scale", ks), ("v_scale", vs))
    else:
        writes = (("k", k[:, -n_w:]), ("v", v[:, -n_w:]))
    for key, vals in writes:
        cache[key].index_copy_(1, slots, vals.to(cache[key].dtype))
    cache["slot_pos"].index_copy_(0, slots, pos_w.to(torch.int32))
    return cache


def _cache_read(cache: dict, dtype):
    """The whole ring as (k, v) in ``dtype`` (int4 dequantized)."""
    if "k_idx" in cache:
        book = cache["kv_codebook"]
        return (_kv_dequantize(cache["k_idx"], cache["k_scale"], book, dtype),
                _kv_dequantize(cache["v_idx"], cache["v_scale"], book, dtype))
    return cache["k"], cache["v"]


def _paged_write(cache: dict, k, v, positions, ctx_lens) -> dict:
    """Store this call's tokens in their pool slots, in place.

    A token is written iff ``0 <= position < ctx_lens[b]`` and its table
    entry is allocated. The others (padding, idle rows) go to the pool's
    scratch block, as JAX sends them to an out-of-bounds index and drops
    them: every cell is written by one ``index_copy_`` of a fixed shape, and
    no mask decides a shape on the host. Many dropped cells may land on the
    same scratch cell in any order; nothing ever reads it."""
    quantized = "pages_k_idx" in cache
    pages = cache["pages_k_idx"] if quantized else cache["pages_k"]
    n_blocks, bs = pages.shape[0], pages.shape[1]
    bt = cache["block_tables"]
    blk = torch.clamp(positions // bs, 0, bt.shape[1] - 1).long()
    block_id = torch.gather(bt, 1, blk)
    valid = (positions >= 0) & (positions < ctx_lens[:, None]) & (block_id >= 0)
    dest = torch.where(valid, block_id.long() * bs + positions % bs, n_blocks * bs).reshape(-1)
    if quantized:
        ki, ks = _kv_quantize(k, cache["kv_codebook"])
        vi, vs = _kv_quantize(v, cache["kv_codebook"])
        writes = (("pages_k_idx", ki), ("pages_v_idx", vi),
                  ("pages_k_scale", ks), ("pages_v_scale", vs))
    else:
        writes = (("pages_k", k.to(pages.dtype)), ("pages_v", v.to(pages.dtype)))
    for key, vals in writes:
        _cells_with_scratch(cache[key]).index_copy_(0, dest, vals.reshape(-1, *vals.shape[2:]))
    return cache


def _paged_attend(cache: dict, q, q_pos, softcap: float, window: int = 0) -> torch.Tensor:
    """Attention against the block pool through the block table."""
    qf, qp = q.float().contiguous(), q_pos.int().contiguous()
    bt = cache["block_tables"].contiguous()
    kernel = kr.resolve_paged_route(q.device) == "pallas"
    if "pages_k_idx" in cache:
        attend = paged_attn_int4 if kernel else paged_attn_quant_plain
        o = attend(qf, cache["pages_k_idx"], cache["pages_k_scale"], cache["pages_v_idx"],
                   cache["pages_v_scale"], cache["kv_codebook"], bt, cache["ctx_lens"], qp,
                   softcap=softcap, window=window)
    else:
        attend = paged_attn_bf16 if kernel else paged_attn_plain
        o = attend(qf, cache["pages_k"], cache["pages_v"], bt, cache["ctx_lens"], qp,
                   softcap=softcap, window=window)
    return o.to(q.dtype)


def _head_layout(q: torch.Tensor, h: int, kv: int, cached: bool) -> str:
    """How a sharded step splits the flat heads of ``q`` (B, S, H * hd)
    into (KV, G) heads: ``"plain"`` where no mesh dim shards them or its
    size divides KV (the KV heads are sharded); else, without a cache,
    ``"expand"`` where it divides H (each KV head repeated for its G query
    heads, the query heads sharded), otherwise ``"gather"`` (the heads
    whole on every rank; the ring cache's site then splits the query
    heads itself). DTensor cannot split a sharded dim into factors the
    mesh does not divide. A plain tensor is ``"plain"``."""
    if not isinstance(q, DTensor):
        return "plain"
    sizes = [q.device_mesh.size(i) for i, pl in enumerate(q.placements)
             if isinstance(pl, Shard) and pl.dim == q.ndim - 1]
    m = math.prod(sizes)
    if m == 1 or kv % m == 0:
        return "plain"
    return "gather" if cached or h % m else "expand"


def _ring_attend(cache: dict, q, k, v, positions, window: int, softcap: float, cfg):
    """Ring write, ring read and attention: (out, cache). On DTensors (a
    sharded serving step) each rank runs them on its own batch rows and, where
    the cache shards them, its KV heads: the cache's other model shards
    (head_dim) are gathered for the step and the rank writes back its own
    slice; ``slot_pos`` is replicated and every rank writes it alike. With
    head_dim sharded on one mesh dim whose size divides the query heads,
    each rank attends its share of the query heads (each with its KV head),
    out (B, S, H, 1, hd) sharded on them."""
    if not isinstance(q, DTensor):
        cache = _cache_write(cache, k, v, positions)
        ck, cv = _cache_read(cache, q.dtype)
        return _attn_dispatch(q, ck, cv, positions, cache["slot_pos"], window, True, softcap,
                              cfg, k_min=cache.get("pad_len")), cache
    ref = cache["k_idx" if "k_idx" in cache else "k"]
    mesh = ref.device_mesh
    work = [pl if isinstance(pl, Shard) and pl.dim in _ROW_AND_HEAD else Replicate()
            for pl in ref.placements]
    rep = [Replicate()] * mesh.ndim

    def local(t, placements):
        if not isinstance(t, DTensor):
            return t
        return (t if list(t.placements) == placements
                else t.redistribute(mesh, placements)).to_local()

    loc = {key: local(t, work if t.ndim == 4 else rep) for key, t in cache.items()}
    pos = local(positions, rep)
    loc = _cache_write(loc, local(k, work), local(v, work), pos)
    coord = mesh.get_coordinate()
    for key, t in cache.items():
        if not isinstance(t, DTensor) or t.ndim != 4 or list(t.placements) == work:
            continue
        shard = loc[key]
        for i, (pl, wpl) in enumerate(zip(t.placements, work)):
            if isinstance(pl, Shard) and pl != wpl:
                n = shard.shape[pl.dim] // mesh.size(i)
                shard = shard.narrow(pl.dim, coord[i] * n, n)
        t.to_local().copy_(shard)
    ck, cv = _cache_read(loc, q.dtype)
    ql = local(q, work)
    b, s, kvh, g, hd = q.shape
    split = [i for i, (pl, wpl) in enumerate(zip(ref.placements, work))
             if isinstance(pl, Shard) and pl != wpl]
    out_pl, shape = work, q.shape
    if len(split) == 1 and (kvh * g) % mesh.size(split[0]) == 0 and g > 1:
        n = kvh * g // mesh.size(split[0])
        h0 = coord[split[0]] * n
        k0, k1 = h0 // g, (h0 + n - 1) // g + 1
        heads = lambda t: t[:, :, k0:k1].repeat_interleave(g, dim=2)[:, :, h0 - k0 * g :
                                                                      h0 - k0 * g + n]
        ql = ql.reshape(*ql.shape[:2], kvh * g, 1, hd)[:, :, h0 : h0 + n]
        ck, cv = heads(ck), heads(cv)
        out_pl, shape = list(work), (b, s, kvh * g, 1, hd)
        out_pl[split[0]] = Shard(2)
    o = _attn_dispatch(ql, ck, cv, pos, loc["slot_pos"], window, True, softcap, cfg,
                       k_min=loc.get("pad_len"))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(o.contiguous(), mesh, out_pl, run_check=False, shape=shape,
                              stride=stride), cache


def attention_apply(p: Attention, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                    cache: dict | None = None, memory: torch.Tensor | None = None,
                    window: int = 0, layer_tag: str = "attn"):
    """GQA attention. Returns (out, cache).

    ``positions``: (S,) shared (no cache, ring cache) or (B, S) per row
    (paged serving, -1 = padded cell). A paged cache may carry
    ``token_slots`` (B,): the packed layout, where the tables are per
    scheduler slot and each row is a segment of slot ``token_slots[b]``. A
    ring cache may carry ``pad_len`` (B,): keys at positions below it are
    masked. ``layer_tag`` prefixes the projections' probe sites
    (``attn.q`` .. ``attn.o``).

    ``memory`` (B, M, d) makes it cross-attention: keys and values are
    projected from the memory, with no RoPE, every key visible (positions
    0, not causal). A cross cache that holds ``ck`` / ``cv`` is read and
    never written, and the K/V projections are not called: JAX's rule
    (``repro/models/layers.py``), under which the serving engines, whose
    cross caches start holding zeros, attend zeros at prefill as at decode.
    A cache dict without them receives this call's keys and values in
    bfloat16.

    Between the projections lies the region ``attn.core``
    (``serving.telemetry.region``): RoPE, the KV write and the attention.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    softcap = cfg.logit_softcap
    cross = memory is not None

    q = constrain(dense_apply(p.wq, x, f"{layer_tag}.q"), "batch", "seq", "heads_flat")
    if cross and cache is not None and "ck" in cache:
        k, v = cache["ck"], cache["cv"]
    else:
        src = memory if cross else x
        k = dense_apply(p.wk, src, f"{layer_tag}.k")
        v = dense_apply(p.wv, src, f"{layer_tag}.v")
    region("attn.core")
    layout = _head_layout(q, h, kv, cached=cache is not None)
    if layout == "expand":  # one KV head per query head: shard the query heads
        k, v = (gather_dim(t, -1).reshape(b, -1, kv, hd).repeat_interleave(g, dim=2)
                for t in (k, v))
        kv, g = h, 1
    elif layout == "gather":
        q, k, v = (gather_dim(gather_dim(t, -1), 2) if t.ndim == 4 else gather_dim(t, -1)
                   for t in (q, k, v))
    q = q.reshape(b, s, kv, g, hd)
    k, v = k.reshape(b, -1, kv, hd), v.reshape(b, -1, kv, hd)
    if not cross and cfg.pos_embed == "rope":
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    if layout == "plain":
        q = constrain(q, "batch", "seq", "kv_heads", None, None)
        k = constrain(k, "batch", "seq" if not cross else None, "kv_heads", None)
        v = constrain(v, "batch", "seq" if not cross else None, "kv_heads", None)

    if cross:
        if cache is not None and "ck" not in cache:
            cache = {"ck": k.to(torch.bfloat16), "cv": v.to(torch.bfloat16)}
        k_pos = torch.zeros((k.shape[1],), dtype=torch.int32, device=k.device)
        o = run_local(lambda q, k, v: _attn_dispatch(q, k, v, positions, k_pos, 0, False,
                                                     softcap, cfg),
                      q, k.to(q.dtype), v.to(q.dtype), dims=_ROW_AND_HEAD)
    elif cache is not None and "block_tables" in cache:
        if "token_slots" in cache:
            cache = cache | {"block_tables": cache["block_tables"][cache["token_slots"].long()]}
        q_pos = positions if positions.ndim == 2 else positions.expand(b, s)
        cache = _paged_write(cache, k, v, q_pos, cache["ctx_lens"])
        o = _paged_attend(cache, q, q_pos, softcap, window)
    elif cache is not None:
        o, cache = _ring_attend(cache, q, k, v, positions, window, softcap, cfg)
    else:
        o = run_local(lambda q, k, v: _attn_dispatch(q, k, v, positions, positions, window,
                                                     True, softcap, cfg),
                      q, k, v, dims=_ROW_AND_HEAD)
    region("other")
    o = constrain(o.reshape(b, s, h * hd), "batch", "seq", "heads_flat")
    out = dense_apply(p.wo, o, f"{layer_tag}.o")
    if p.gate is not None:  # gated cross-attention
        out = torch.tanh(p.gate.to(out.dtype)) * out
    return out, cache


GATED_ACTS = ("silu", "gelu")  # a fused [gate; up] projection, mlp.wi 2 * d_ff wide


def act_apply(h: torch.Tensor, act_fn: str) -> torch.Tensor:
    """The MLP's hidden activation: gated SiLU or GeLU over the ``[gate; up]``
    halves, squared ReLU (``relu2``) or plain GeLU (``gelu_plain``). GeLU is
    the tanh approximation, ``jax.nn.gelu``'s default.

    A DTensor sharded on the hidden dim holds gate columns on some ranks
    and up columns on others: the halves are gathered, and the product
    sharded again as h was (one local site; DTensor's split of the sharded
    dim leaves a strided layout whose backward replicates the projection's
    weight gradient)."""
    if act_fn in GATED_ACTS:
        whole = gather_dim(h, -1)
        gate, up = torch.chunk(whole, 2, dim=-1)
        act = F.silu(gate) if act_fn == "silu" else F.gelu(gate, approximate="tanh")
        out = act * up
        if whole is not h:
            out = out.redistribute(h.device_mesh, [Replicate() if pl.is_partial() else pl
                                                   for pl in h.placements])
        return out
    if act_fn == "relu2":
        return torch.square(F.relu(h))
    if act_fn == "gelu_plain":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {act_fn!r}")


def mlp_apply(p: MLP, x: torch.Tensor, act_fn: str = "silu",
              layer_tag: str = "mlp") -> torch.Tensor:
    """The MLP (probe sites ``<layer_tag>.wi`` and ``<layer_tag>.wd``)."""
    hidden = act_apply(dense_apply(p.wi, x, f"{layer_tag}.wi"), act_fn)
    hidden = constrain(hidden, "batch", "seq", "d_ff")
    return dense_apply(p.wd, hidden, f"{layer_tag}.wd")


def mlp_init(gen: torch.Generator, d: int, d_ff: int, act_fn: str, dtype, device) -> MLP:
    """``wi`` (d, 2 d_ff) for the gated activations, else (d, d_ff), and
    ``wd`` at JAX's scales."""
    mult = 2 if act_fn in GATED_ACTS else 1
    return MLP(dense_init(gen, d, mult * d_ff, dtype, device),
               dense_init(gen, d_ff, d, dtype, device, 1.0 / math.sqrt(d_ff)))


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None, bias: bool = False) -> Dense:
    """Seeded normal init, ``1/sqrt(d_in)`` by default (the JAX scheme);
    ``bias`` adds a zero bias."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device) * s
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    return Dense(w.to(dtype), b)
