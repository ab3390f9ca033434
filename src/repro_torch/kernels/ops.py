"""Wrappers that adapt the kernels to the core types (port of ``repro/kernels/ops.py``).

``lut_gemm`` (activation indices in) and ``lut_gemm_fused`` (raw activations
in, quantized in the tile) apply the rank-1 scales around the unscaled
kernel product and dispatch both weight tiers (nibble <= 4 bits, byte 5..8
bits); ``bucketize`` is the Clustering Unit; ``topk_outlier`` is the Orizuru
detection; ``quantize_outlier_streaming`` quantizes and detects in one read
of the activations. Leading batch axes are flattened here.
``autotune_lut_blocks`` and ``index_histogram`` are not ported.
"""

from __future__ import annotations

import torch

from repro_torch.core.codebook import boundaries_from_centroids
from repro_torch.core.outlier import OutlierSet
from repro_torch.core.quantize import QuantizedActivation, QuantizedWeight, token_scale
from repro_torch.kernels.bucketize import bucketize_call
from repro_torch.kernels.lut_gemm import fused_lut_gemm
from repro_torch.kernels.lut_gemm import lut_gemm as lut_gemm_call
from repro_torch.kernels.topk_outlier import streaming_quantize_outlier_call, topk_outlier_call

__all__ = ["lut_gemm", "lut_gemm_fused", "bucketize", "topk_outlier",
           "quantize_outlier_streaming"]


def _outlier_set(hv, hi, lv, li, lead, k: int) -> OutlierSet:
    values = torch.cat([hv, lv], dim=-1).reshape(*lead, 2 * k)
    channels = torch.cat([hi, li], dim=-1).reshape(*lead, 2 * k)
    return OutlierSet(values=values, channels=channels, mask=torch.ones_like(values))


def lut_gemm(qa: QuantizedActivation, qw: QuantizedWeight,
             out_dtype=torch.float32) -> torch.Tensor:
    """Index-GEMM kernel with the per-token and per-channel scales; matches
    ``core.lut_gemm.lut_gemm``."""
    lead = qa.idx.shape[:-1]
    idx2d = qa.idx.reshape(-1, qa.idx.shape[-1]).int().contiguous()
    y = lut_gemm_call(idx2d, qw.packed.contiguous(), qa.codebook.float().contiguous(),
                      qw.codebook.float().contiguous(), byte_packed=qw.nbits > 4)
    y = y.reshape(*lead, qw.shape[1])
    return (y * qa.scale * qw.scale).to(out_dtype)


def lut_gemm_fused(x: torch.Tensor, codebook: torch.Tensor, qw: QuantizedWeight,
                   scale_mode: str = "rms", out_dtype=torch.float32) -> torch.Tensor:
    """Fused quantize + index-GEMM with the per-token and per-channel scales.

    Index selection equals ``quantize_activation``'s for the input dtype
    (float32: ``x / s`` form; bfloat16: ``x >= s * b`` form)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).contiguous()
    s = token_scale(x2d, scale_mode)
    book = codebook.float().contiguous()
    y = fused_lut_gemm(x2d, s, qw.packed.contiguous(),
                       boundaries_from_centroids(book).contiguous(), book,
                       qw.codebook.float().contiguous(), byte_packed=qw.nbits > 4,
                       mul_form=x.dtype == torch.bfloat16)
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
