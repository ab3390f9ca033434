"""Paged attention over the KV pool: CUDA kernel wrappers and plain versions.

Replaces both variants of ``repro/kernels/paged_attn.py::paged_attn_kernel_call``:

* int4 K-Means pages: :func:`paged_attn_int4` (kernel
  ``repro_torch/csrc/paged_attn_int4.cu``), plain version
  :func:`paged_attn_quant_plain`, the port of ``ref.paged_attn_quant_ref``;
  pools (n_blocks, bs, KV, hd/2) uint8 and (n_blocks, bs, KV, 1) float32.
* float pages: :func:`paged_attn_bf16` (kernel
  ``repro_torch/csrc/paged_attn_bf16.cu``), plain version
  :func:`paged_attn_plain`, the port of ``ref.paged_attn_ref``; pools
  (n_blocks, bs, KV, hd) bfloat16 or float32, as the TPU kernel takes them.

Layouts are the JAX ones: q (B, S, KV, G, hd) float32; tables (B, max_blk)
int32 (< 0 = unallocated); ctx_lens (B,) and q_pos (B, S) int32 (< 0 =
padded row). Output float32 in q's shape. Rows that see no valid key are
finite but meaningless in both versions (the plain one averages every
gathered value, the kernel gives 0) and are discarded by callers.

Both kernels share one body (``csrc/paged_attn_common.cuh``): the grid is
(splits, KV, B), each block owning a run of whole pages of one row's table,
and the last block of each (row, head) merges the splits' partial softmax
states in split order. :func:`split_plan` picks the split from shapes alone,
so a launch never reads ``ctx_lens`` on the host.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["paged_attn_int4", "paged_attn_quant_plain", "paged_attn_bf16", "paged_attn_plain",
           "split_plan"]

NAME = "paged_attn_int4"
FLOAT = "paged_attn_bf16"
_NEG_INF = torch.finfo(torch.float32).min
SPLIT_WAVE = 4  # blocks per SM the split aims at
SPLIT_MIN_KEYS = 256  # keys per split at least: four ring slots of 64
SPLIT_MAX_PAGES = 2048  # pages per split at most (the block's table in shared memory)


def _deq(idx: torch.Tensor, scale: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    full = torch.stack([idx & 0xF, idx >> 4], dim=-1).reshape(*idx.shape[:-1], -1)
    return codebook[full.long()] * scale


def _attend_gathered(q, gk, gv, ctx_lens, q_pos, softcap: float, window: int) -> torch.Tensor:
    """q (B, S, KV, G, hd) against gathered float32 keys / values
    (B, max_blk * bs, KV, hd), with the causal, context and window masks."""
    k_pos = torch.arange(gk.shape[1], dtype=torch.int32, device=q.device)
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), gk) * (q.shape[-1] ** -0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    valid = (k_pos[None, None, :] < ctx_lens[:, None, None]) & (
        k_pos[None, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid &= k_pos[None, None, :] > q_pos[:, :, None] - window
    s = torch.where(valid[:, None, None], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, gv)


def paged_attn_quant_plain(q, k_idx, k_scale, v_idx, v_scale, codebook, block_tables,
                           ctx_lens, q_pos, *, softcap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    """Gather the packed blocks of each row, dequantize, attend with masks."""
    if q.is_cuda:
        build.PLAIN_ON_CUDA[NAME] += 1
    n_blocks = k_idx.shape[0]
    bt = block_tables.long().clamp(0, n_blocks - 1)
    b = bt.shape[0]
    gk = _deq(k_idx[bt], k_scale[bt], codebook).reshape(b, -1, k_idx.shape[2],
                                                        2 * k_idx.shape[3])
    gv = _deq(v_idx[bt], v_scale[bt], codebook).reshape(gk.shape)
    return _attend_gathered(q, gk, gv, ctx_lens, q_pos, softcap, window)


def paged_attn_plain(q, pages_k, pages_v, block_tables, ctx_lens, q_pos, *,
                     softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Gather the float blocks of each row, widen to float32, attend with masks."""
    if q.is_cuda:
        build.PLAIN_ON_CUDA[FLOAT] += 1
    n_blocks = pages_k.shape[0]
    bt = block_tables.long().clamp(0, n_blocks - 1)
    b = bt.shape[0]
    gk = pages_k[bt].reshape(b, -1, *pages_k.shape[2:]).float()
    gv = pages_v[bt].reshape(b, -1, *pages_v.shape[2:]).float()
    return _attend_gathered(q, gk, gv, ctx_lens, q_pos, softcap, window)


def split_plan(b: int, kv: int, max_blk: int, bs: int, sms: int = build.SMS) -> tuple[int, int]:
    """``(splits, pages_per_split)`` of a launch over B rows, KV heads and
    tables of ``max_blk`` pages of ``bs`` keys, on a card of ``sms`` SMs.
    Split i owns pages ``[i * pages_per_split, (i + 1) * pages_per_split)``
    of ``[0, max_blk)``; enough splits that ``SPLIT_WAVE`` blocks per SM are
    launched, none shorter than ``SPLIT_MIN_KEYS`` keys unless the table is.
    Shapes only: the context lengths stay on the card, and each block reads
    its own (splits past it return at once)."""
    pairs = max(1, b * kv)
    most = max(1, -(-max_blk // max(1, -(-SPLIT_MIN_KEYS // bs))))
    splits = min(max(1, -(-SPLIT_WAVE * sms // pairs)), most)
    splits = max(splits, -(-max_blk // SPLIT_MAX_PAGES))
    pps = max(1, -(-max_blk // splits))
    return max(1, -(-max_blk // pps)), pps


def _split_launch(q, bs: int, max_blk: int) -> tuple[list, int]:
    """The kernels' trailing arguments (pages per split, splits, workspace,
    tickets, stream) and the workspace tensor that must outlive the call."""
    b, s, kv, g, hd = q.shape
    splits, pps = split_plan(b, kv, max_blk, bs)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(b * kv * splits * s * g * (hd + 2), dtype=torch.float32, device=q.device)
        tickets = build.tickets(q.device, stream, b * kv)
    ptr = lambda t: None if t is None else t.data_ptr()
    return [pps, splits, ptr(ws), ptr(tickets), stream], ws


def _require(cond: bool, msg: str, name: str = NAME) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_query(name: str, q, block_tables, ctx_lens, q_pos) -> None:
    _require(q.dim() == 5 and q.dtype == torch.float32,
             f"q must be float32 (B, S, KV, G, hd), got {q.dtype} {tuple(q.shape)}", name)
    b, s = q.shape[:2]
    _require(block_tables.dim() == 2 and block_tables.shape[0] == b
             and block_tables.dtype == torch.int32, "block_tables must be int32 (B, max_blk)",
             name)
    _require(tuple(ctx_lens.shape) == (b,) and ctx_lens.dtype == torch.int32,
             "ctx_lens must be int32 (B,)", name)
    _require(tuple(q_pos.shape) == (b, s) and q_pos.dtype == torch.int32,
             "q_pos must be int32 (B, S)", name)


def paged_attn_int4(q, k_idx, k_scale, v_idx, v_scale, codebook, block_tables, ctx_lens,
                    q_pos, *, softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """CPU tensors run the plain version; CUDA tensors launch the kernel."""
    _check_query(NAME, q, block_tables, ctx_lens, q_pos)
    b, s, kv, g, hd = q.shape
    n_blocks, bs = k_idx.shape[0], k_idx.shape[1]
    _require(hd % 2 == 0 and hd <= 256, f"head_dim {hd} must be even and <= 256")
    pool = (n_blocks, bs, kv)
    for t, last, dt in ((k_idx, hd // 2, torch.uint8), (v_idx, hd // 2, torch.uint8),
                        (k_scale, 1, torch.float32), (v_scale, 1, torch.float32)):
        _require(tuple(t.shape) == (*pool, last) and t.dtype == dt,
                 f"pool array {t.dtype} {tuple(t.shape)} != {dt} {(*pool, last)}")
    _require(tuple(codebook.shape) == (16,) and codebook.dtype == torch.float32,
             "codebook must be float32 (16,)")
    tensors = (q, k_idx, k_scale, v_idx, v_scale, codebook, block_tables, ctx_lens, q_pos)
    _require(all(t.device == q.device for t in tensors), "inputs must share one device")
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    if q.device.type == "cpu":
        return paged_attn_quant_plain(q, k_idx, k_scale, v_idx, v_scale, codebook,
                                      block_tables, ctx_lens, q_pos, softcap=softcap,
                                      window=window)
    _require(q.is_cuda, f"unsupported device {q.device}")
    out = torch.empty_like(q)
    fn = build.entry(NAME, "p" * 10 + "i" * 8 + "fifiippp")
    tail, _ws = _split_launch(q, bs, block_tables.shape[1])
    err = fn(q.data_ptr(), k_idx.data_ptr(), k_scale.data_ptr(), v_idx.data_ptr(),
             v_scale.data_ptr(), codebook.data_ptr(), block_tables.data_ptr(),
             ctx_lens.data_ptr(), q_pos.data_ptr(), out.data_ptr(), b, s, kv, g, hd,
             n_blocks, bs, block_tables.shape[1], float(softcap), int(window),
             float(hd ** -0.5), *tail)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out


def paged_attn_bf16(q, pages_k, pages_v, block_tables, ctx_lens, q_pos, *,
                    softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Float pages (bfloat16 or float32). CPU tensors run the plain version;
    CUDA tensors launch the kernel."""
    _check_query(FLOAT, q, block_tables, ctx_lens, q_pos)
    b, s, kv, g, hd = q.shape
    n_blocks, bs = pages_k.shape[0], pages_k.shape[1]
    _require(hd <= 256, f"head_dim {hd} must be <= 256", FLOAT)
    _require(pages_k.dtype in (torch.bfloat16, torch.float32), f"page dtype {pages_k.dtype}",
             FLOAT)
    for t in (pages_k, pages_v):
        _require(tuple(t.shape) == (n_blocks, bs, kv, hd) and t.dtype == pages_k.dtype,
                 f"pool array {t.dtype} {tuple(t.shape)} != {pages_k.dtype} "
                 f"{(n_blocks, bs, kv, hd)}", FLOAT)
    tensors = (q, pages_k, pages_v, block_tables, ctx_lens, q_pos)
    _require(all(t.device == q.device for t in tensors), "inputs must share one device", FLOAT)
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous", FLOAT)
    if q.device.type == "cpu":
        return paged_attn_plain(q, pages_k, pages_v, block_tables, ctx_lens, q_pos,
                                softcap=softcap, window=window)
    _require(q.is_cuda, f"unsupported device {q.device}", FLOAT)
    out = torch.empty_like(q)
    fn = build.entry(FLOAT, "pppipppp" + "i" * 8 + "fifiippp")
    tail, _ws = _split_launch(q, bs, block_tables.shape[1])
    err = fn(q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
             int(pages_k.dtype == torch.bfloat16), block_tables.data_ptr(), ctx_lens.data_ptr(),
             q_pos.data_ptr(), out.data_ptr(), b, s, kv, g, hd, n_blocks, bs,
             block_tables.shape[1], float(softcap), int(window), float(hd ** -0.5), *tail)
    build.check(err, FLOAT)
    build.LAUNCHES[FLOAT] += 1
    return out
