"""Factorized LUT-GEMM, the plain tensor route (port of ``repro/core/lut_gemm.py``).

Both operands are indices into learned codebooks, so

    Y[m, n] = sA[m] * sW[n] * sum_k cA[aIdx[m, k]] * cW[wIdx[k, n]]

The centroids are gathered and the reduction is one matrix product. The hand
kernel that fuses the activation quantization into the GEMM tile lives in
``repro_torch/kernels/lut_gemm.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import QuantizedActivation, QuantizedWeight

__all__ = ["lut_gemm"]


def lut_gemm(qa: QuantizedActivation, qw: QuantizedWeight, out_dtype=torch.float32,
             compute_dtype=torch.float32) -> torch.Tensor:
    a = qa.codebook[qa.idx.long()].to(compute_dtype)  # (..., K)
    w = qw.centroids().to(compute_dtype)  # (K, N)
    y = a @ w
    return (y * qa.scale.to(compute_dtype) * qw.scale.to(compute_dtype)).to(out_dtype)
