"""Wrappers that adapt the kernels to the core types (port of ``repro/kernels/ops.py``).

Only the two entry points the serving path calls are ported:
``lut_gemm_fused`` (raw activations in, scaled output out) and
``topk_outlier`` (an :class:`OutlierSet`). Leading batch axes are flattened
here and the rank-1 scales applied around the unscaled kernel product.
"""

from __future__ import annotations

import torch

from repro_torch.core.codebook import boundaries_from_centroids
from repro_torch.core.outlier import OutlierSet
from repro_torch.core.quantize import QuantizedWeight, token_scale
from repro_torch.kernels.lut_gemm import fused_lut_gemm
from repro_torch.kernels.topk_outlier import topk_outlier_call

__all__ = ["lut_gemm_fused", "topk_outlier"]


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


def topk_outlier(x: torch.Tensor, k: int) -> OutlierSet:
    """Orizuru detection -> OutlierSet (top-k then bottom-k, mask all ones)."""
    lead = x.shape[:-1]
    hv, hi, lv, li = topk_outlier_call(x.reshape(-1, x.shape[-1]).float().contiguous(), k)
    values = torch.cat([hv, lv], dim=-1).reshape(*lead, 2 * k)
    channels = torch.cat([hi, li], dim=-1).reshape(*lead, 2 * k)
    return OutlierSet(values=values, channels=channels, mask=torch.ones_like(values))
