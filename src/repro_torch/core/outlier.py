"""Outlier detection and look-ahead compensation (port of ``repro/core/outlier.py``).

The main branch quantizes every activation; the outlier branch finds the
top-k largest and bottom-k smallest activations of each token, takes their
residuals ``r = x - q(x)`` and adds ``r @ W~[channels, :]``.

Tie order is part of the contract: among equal values the lowest channel
wins (``lax.top_k``). ``torch.topk`` does not promise that order, so the
plain detection sorts stably, on :func:`order_key`: CUDA's ``torch.sort``
orders NaN by their bits where the CPU's ranks them alike, and the key
gives both devices (and the Orizuru kernels) one order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import codebook as cb
from repro_torch.core.quantize import (
    QuantizedActivation,
    QuantizedWeight,
    bucketize_mul_form,
    dequantize_activation,
)
from repro_torch.serving.telemetry import region

__all__ = [
    "OutlierSet",
    "num_outliers",
    "order_key",
    "stable_topk",
    "detect_outliers_topk",
    "detect_outliers_static",
    "static_thresholds",
    "outlier_residuals",
    "outlier_residuals_direct",
    "compensate_gather",
    "compensate_scatter",
    "orizuru_comparisons",
    "naive_topk_comparisons",
]


@dataclasses.dataclass(frozen=True)
class OutlierSet:
    """values (..., T) float32, channels (..., T) int32, mask (..., T) float32."""

    values: torch.Tensor
    channels: torch.Tensor
    mask: torch.Tensor


def num_outliers(k_channels: int, frac: float) -> int:
    """Outliers per side for a token of ``k_channels`` (paper: frac=0.005)."""
    return max(1, int(round(k_channels * frac)))


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The Orizuru kernels' order key of float32 ``x``
    (``csrc/topk_select.cuh::order_key``) as int64 in [0, 2^32): the sign
    flip of the bits (``bits ^ 0x80000000`` for non-negative values,
    ``~bits`` for negative ones), with -0.0 mapped onto +0.0 and every NaN
    onto 0xFFFFFFFF. Monotone in the detection order: hi takes the largest
    keys, lo the smallest, ties to the lowest channel."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    key = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, key)


def stable_topk(x: torch.Tensor, k: int, largest: bool = True):
    """``lax.top_k`` semantics: k extreme values along the last axis, ties
    broken by the lowest index (a stable sort of :func:`order_key`, then the
    first k, the values read back from ``x``)."""
    _, i = torch.sort(order_key(x), dim=-1, descending=largest, stable=True)
    i = i[..., :k]
    return torch.gather(x, -1, i), i.int()


def detect_outliers_topk(x: torch.Tensor, k: int) -> OutlierSet:
    """Dynamic detection: k largest (descending) then k smallest (ascending)."""
    hi_v, hi_i = stable_topk(x, k, largest=True)
    lo_v, lo_i = stable_topk(x, k, largest=False)
    values = torch.cat([hi_v, lo_v], dim=-1).float()
    channels = torch.cat([hi_i, lo_i], dim=-1)
    return OutlierSet(values=values, channels=channels, mask=torch.ones_like(values))


def detect_outliers_static(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                           k: int) -> OutlierSet:
    """OASIS-S: the 2k largest threshold violations, the rest masked."""
    score = torch.clamp(x - hi, min=0.0) + torch.clamp(lo - x, min=0.0)
    sv, si = stable_topk(score, 2 * k, largest=True)
    values = torch.gather(x, -1, si.long()).float()
    return OutlierSet(values=values, channels=si, mask=(sv > 0).float())


def static_thresholds(calib_x: torch.Tensor, frac: float = 0.005):
    """OASIS-S: scalar (lo, hi) thresholds, the ``frac`` and ``1 - frac``
    quantiles ('linear') over all calibration activations. Sorts and
    interpolates itself: ``torch.quantile`` refuses inputs this large."""
    flat = torch.sort(calib_x.reshape(-1).float()).values
    qs = torch.tensor([frac, 1.0 - frac], dtype=torch.float32, device=flat.device)
    lo, hi = cb._sorted_quantiles(flat, qs)
    return lo, hi


def outlier_residuals(out: OutlierSet, qa: QuantizedActivation) -> torch.Tensor:
    """``r = x - q(x)`` at the outlier channels, from a full activation set."""
    deq = dequantize_activation(qa)
    q_at = torch.gather(deq, -1, out.channels.long())
    return (out.values - q_at) * out.mask


def outlier_residuals_direct(out: OutlierSet, scale: torch.Tensor,
                             codebook: torch.Tensor, mul_form: bool = False) -> torch.Tensor:
    """``r = x - q(x)`` recomputed from the gathered outlier values alone
    (the fused GEMM route never materialises activation indices)."""
    v = out.values
    if mul_form:
        b = cb.boundaries_from_centroids(codebook)
        idx = bucketize_mul_form(v, scale, b, dtype=torch.int32)
    else:
        idx = cb.assign_via_boundaries((v / scale).float(), codebook)
    deq = codebook[idx.long()] * scale
    return (v - deq) * out.mask


def compensate_gather(residuals: torch.Tensor, out: OutlierSet, qw: QuantizedWeight,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """``Y'[m, n] = sum_t r[m, t] * W~[ch[m, t], n]`` by gathering weight rows
    (regions ``qlinear.comp_dequant``, then ``qlinear.comp_matmul``)."""
    region("qlinear.comp_dequant")
    w_rows = qw.dequantize_rows(out.channels.long()).to(compute_dtype)  # (..., T, N)
    region("qlinear.comp_matmul")
    r = residuals.to(compute_dtype)
    return (r.unsqueeze(-2) @ w_rows).squeeze(-2)


def compensate_scatter(residuals: torch.Tensor, out: OutlierSet, qw: QuantizedWeight,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """Scatter-add residuals into a dense (..., K) matrix, one dense product
    with the dequantized weight (the prefill-sized route). The scatter
    counts to the caller's region (``qlinear.residual``), then
    ``qlinear.comp_dequant`` and ``qlinear.comp_matmul``."""
    k_channels = qw.shape[0]
    lead = residuals.shape[:-1]
    r2 = residuals.reshape(-1, residuals.shape[-1]).to(compute_dtype)
    ch = out.channels.reshape(-1, out.channels.shape[-1]).long()
    rows = torch.arange(r2.shape[0], device=r2.device)[:, None].expand_as(ch)
    r_dense = torch.zeros((r2.shape[0], k_channels), dtype=compute_dtype, device=r2.device)
    r_dense.index_put_((rows, ch), r2, accumulate=True)
    region("qlinear.comp_dequant")
    w = qw.dequantize_rows().to(compute_dtype)
    region("qlinear.comp_matmul")
    return (r_dense @ w).reshape(*lead, w.shape[1])


# ---------------------------------------------------------------------------
# Orizuru comparison-count analytics (paper §IV-D)
# ---------------------------------------------------------------------------

def orizuru_comparisons(n: int, k: int) -> int:
    """1.5N + 2k log2(N): the max tree's N - 1 (~N) comparisons, the min tree
    reusing level one (N/2 saved), log2 N maintenance per each of 2k pops."""
    return int(1.5 * n + 2 * k * math.log2(n))


def naive_topk_comparisons(n: int) -> int:
    """The SpAtten-style top-k engine baseline: ~6N comparisons."""
    return 6 * n
