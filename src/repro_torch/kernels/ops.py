"""Wrappers that adapt the kernels to the core types (port of ``repro/kernels/ops.py``).

``lut_gemm`` (activation indices in) and ``lut_gemm_fused`` (raw activations
in, quantized in the tile) apply the rank-1 scales around the unscaled
kernel product and dispatch both weight tiers (nibble <= 4 bits, byte 5..8
bits); ``bucketize`` is the Clustering Unit; ``topk_outlier`` is the Orizuru
detection; ``quantize_outlier_streaming`` quantizes and detects in one read
of the activations. Leading batch axes are flattened here.
``autotune_lut_blocks`` times the LUT-GEMM kernels' tile choices for one
shape and caches the winner, which later calls of that shape use.
``index_histogram`` is not ported.
"""

from __future__ import annotations

import time

import torch

from repro_torch.core.codebook import boundaries_from_centroids
from repro_torch.core.outlier import OutlierSet
from repro_torch.core.quantize import (QuantizedActivation, QuantizedWeight,
                                       quantize_activation, token_scale)
from repro_torch.kernels.bucketize import bucketize_call
from repro_torch.kernels.lut_gemm import check_blocks, fused_lut_gemm
from repro_torch.kernels.lut_gemm import lut_gemm as lut_gemm_call
from repro_torch.kernels.topk_outlier import streaming_quantize_outlier_call, topk_outlier_call

__all__ = ["lut_gemm", "lut_gemm_fused", "autotune_lut_blocks", "bucketize", "topk_outlier",
           "quantize_outlier_streaming"]

# shape key -> (block_m, block_n, block_k), consulted by the LUT-GEMM wrappers
# below when no explicit ``blocks`` is given
_BLOCK_CACHE: dict[tuple, tuple[int, int, int]] = {}

# (block_m, block_n, block_k): the kernels' row tiles and column strips
# (``kernels.lut_gemm.TILES``) with K per split
_CANDIDATES = (
    (80, 256, 256),
    (80, 256, 512),
    (80, 256, 1024),
    (80, 128, 256),
    (80, 128, 512),
    (72, 256, 512),
)


def _block_key(m: int, k: int, n: int, w_nbits: int, a_nbits: int, fused: bool) -> tuple:
    return (m, k, n, w_nbits, a_nbits, fused)


def _cached_blocks(m, k, n, w_nbits, a_nbits, fused) -> tuple[int, int, int] | None:
    return _BLOCK_CACHE.get(_block_key(m, k, n, w_nbits, a_nbits, fused))


def _ms_per_call(fn, reps: int, device: torch.device) -> float:
    """Mean ms per call after one warm-up call: CUDA events on the card, the
    host clock on the CPU (where the plain versions ignore the tile)."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def autotune_lut_blocks(x: torch.Tensor, codebook: torch.Tensor, qw: QuantizedWeight, *,
                        fused: bool = True, candidates=_CANDIDATES,
                        reps: int = 3) -> tuple[int, int, int]:
    """Time each ``(block_m, block_n, block_k)`` candidate on this GEMM shape
    (the fused kernel, or with ``fused=False`` the index kernel on
    ``quantize_activation``'s indices) and cache the fastest; later
    ``lut_gemm`` / ``lut_gemm_fused`` calls of the same shape use it.
    Returns the winner."""
    x2d = x.reshape(-1, x.shape[-1])
    m, k = x2d.shape
    a_nbits = int(codebook.shape[0]).bit_length() - 1
    qa = None if fused else quantize_activation(x2d, codebook)
    best, best_ms = None, float("inf")
    for blocks in candidates:
        blocks = check_blocks(blocks)
        if fused:
            fn = lambda: lut_gemm_fused(x2d, codebook, qw, blocks=blocks)
        else:
            fn = lambda: lut_gemm(qa, qw, blocks=blocks)
        ms = _ms_per_call(fn, reps, x2d.device)
        if ms < best_ms:
            best, best_ms = blocks, ms
    _BLOCK_CACHE[_block_key(m, k, qw.shape[1], qw.nbits, a_nbits, fused)] = best
    return best


def _outlier_set(hv, hi, lv, li, lead, k: int) -> OutlierSet:
    values = torch.cat([hv, lv], dim=-1).reshape(*lead, 2 * k)
    channels = torch.cat([hi, li], dim=-1).reshape(*lead, 2 * k)
    return OutlierSet(values=values, channels=channels, mask=torch.ones_like(values))


def lut_gemm(qa: QuantizedActivation, qw: QuantizedWeight,
             out_dtype=torch.float32, blocks=None) -> torch.Tensor:
    """Index-GEMM kernel with the per-token and per-channel scales; matches
    ``core.lut_gemm.lut_gemm``. ``blocks``: the kernel's tile (else the
    cached autotune winner for this shape, else the kernel's default)."""
    lead = qa.idx.shape[:-1]
    idx2d = qa.idx.reshape(-1, qa.idx.shape[-1]).int().contiguous()
    m, k = idx2d.shape
    blocks = blocks or _cached_blocks(m, k, qw.shape[1], qw.nbits, qa.nbits, False)
    y = lut_gemm_call(idx2d, qw.packed.contiguous(), qa.codebook.float().contiguous(),
                      qw.codebook.float().contiguous(), byte_packed=qw.nbits > 4,
                      blocks=blocks)
    y = y.reshape(*lead, qw.shape[1])
    return (y * qa.scale * qw.scale).to(out_dtype)


def lut_gemm_fused(x: torch.Tensor, codebook: torch.Tensor, qw: QuantizedWeight,
                   scale_mode: str = "rms", out_dtype=torch.float32,
                   blocks=None) -> torch.Tensor:
    """Fused quantize + index-GEMM with the per-token and per-channel scales.

    Index selection equals ``quantize_activation``'s for the input dtype
    (float32: ``x / s`` form; bfloat16: ``x >= s * b`` form). ``blocks`` as
    for :func:`lut_gemm`."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    m, k = x2d.shape
    a_nbits = int(codebook.shape[0]).bit_length() - 1
    blocks = blocks or _cached_blocks(m, k, qw.shape[1], qw.nbits, a_nbits, True)
    s = token_scale(x2d, scale_mode)
    book = codebook.float().contiguous()
    y = fused_lut_gemm(x2d, s, qw.packed.contiguous(),
                       boundaries_from_centroids(book).contiguous(), book,
                       qw.codebook.float().contiguous(), byte_packed=qw.nbits > 4,
                       mul_form=x.dtype == torch.bfloat16, blocks=blocks)
    y = y.reshape(*lead, qw.shape[1])
    return (y * s.reshape(*lead, 1) * qw.scale).to(out_dtype)


def bucketize(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid int32 indices through the Clustering-Unit kernel."""
    x2d = x.reshape(-1, x.shape[-1]).float().contiguous()
    b = boundaries_from_centroids(codebook.float()).contiguous()
    return bucketize_call(x2d, b).reshape(x.shape)


def topk_outlier(x: torch.Tensor, k: int) -> OutlierSet:
    """Orizuru detection -> OutlierSet (top-k then bottom-k, mask all ones)."""
    lead = x.shape[:-1]
    outs = topk_outlier_call(x.reshape(-1, x.shape[-1]).float().contiguous(), k)
    return _outlier_set(*outs, lead, k)


def quantize_outlier_streaming(x: torch.Tensor, codebook: torch.Tensor, k: int,
                               scale_mode: str = "rms"):
    """One read of the activations -> (QuantizedActivation, OutlierSet).

    The same ``QuantizedActivation`` as ``quantize_activation`` (indices and
    scale, int8 indices for bfloat16 input) and the same ``OutlierSet`` as
    ``topk_outlier`` on the float32 activations. On NaN-free activations only:
    a NaN gets index 0 here (a compare sum) but ``len(b)`` from float32
    ``quantize_activation`` (``searchsorted``), as in the JAX package."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    s = token_scale(x2d, scale_mode)
    book = codebook.float()
    mul_form = x.dtype == torch.bfloat16
    idx, *outs = streaming_quantize_outlier_call(
        x2d.float().contiguous(), s, boundaries_from_centroids(book).contiguous(), k,
        mul_form=mul_form)
    if mul_form:
        idx = idx.to(torch.int8)
    nbits = int(codebook.shape[0]).bit_length() - 1
    qa = QuantizedActivation(idx=idx.reshape(x.shape), scale=s.reshape(*lead, 1),
                             codebook=codebook, nbits=nbits)
    return qa, _outlier_set(*outs, lead, k)
