"""Factorized LUT-GEMM, the plain tensor route (port of ``repro/core/lut_gemm.py``).

Both operands are indices into learned codebooks, so

    Y[m, n] = sA[m] * sW[n] * sum_k cA[aIdx[m, k]] * cW[wIdx[k, n]]

The centroids are gathered and the reduction is one matrix product. The
counting form (the paper's histogram over concatenated indices against the
Cartesian-product LUT) is kept as an oracle. The hand kernels live in
``repro_torch/kernels/lut_gemm.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import QuantizedActivation, QuantizedWeight

__all__ = ["build_lut", "lut_gemm_counting", "lut_gemm", "woq_lut_size", "waq_lut_size",
           "reduction_flops_counting"]


def build_lut(act_codebook: torch.Tensor, wgt_codebook: torch.Tensor) -> torch.Tensor:
    """The Cartesian-product LUT ``(2^nA, 2^nW)``: every centroid product."""
    return torch.outer(act_codebook.float(), wgt_codebook.float())


def lut_gemm_counting(qa: QuantizedActivation, qw: QuantizedWeight,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Counting form: ``counts[m, n, i, j] = sum_k [aIdx[m, k] = i][wIdx[k, n] = j]``,
    then ``Y = sA sW sum_ij counts * LUT``. An oracle for small shapes only:
    it holds O(M * N * 2^(nA + nW)) memory."""
    lut = build_lut(qa.codebook, qw.codebook)
    a1h = torch.nn.functional.one_hot(qa.idx.long(), 2**qa.nbits).float()  # (..., K, 2^nA)
    w1h = torch.nn.functional.one_hot(qw.indices.long(), 2**qw.nbits).float()  # (K, N, 2^nW)
    counts = torch.einsum("...ki,knj->...nij", a1h, w1h)
    y = torch.einsum("...nij,ij->...n", counts, lut)
    return (y * qa.scale * qw.scale).to(out_dtype)


def lut_gemm(qa: QuantizedActivation, qw: QuantizedWeight, out_dtype=torch.float32,
             compute_dtype=torch.float32) -> torch.Tensor:
    a = qa.codebook[qa.idx.long()].to(compute_dtype)  # (..., K)
    w = qw.centroids().to(compute_dtype)  # (K, N)
    y = a @ w
    return (y * qa.scale.to(compute_dtype) * qw.scale.to(compute_dtype)).to(out_dtype)


# ---------------------------------------------------------------------------
# Table-I analytics (LUT sizes, reduction FLOPs)
# ---------------------------------------------------------------------------

def woq_lut_size(mu: int, k: int, entry_bytes: int = 2) -> int:
    """Weight-only LUT size in bytes: 2^mu entries per group, K / mu groups."""
    return (2**mu) * (k // mu) * entry_bytes


def waq_lut_size(n_a: int, n_w: int, entry_bytes: int = 2) -> int:
    """The Cartesian-product LUT: 2^(nA + nW) entries, independent of K."""
    return (2 ** (n_a + n_w)) * entry_bytes


def reduction_flops_counting(n_a: int, n_w: int, n_out: int) -> int:
    """Float adds of the counting form's reduction per output row: 2^(nA + nW) N."""
    return (2 ** (n_a + n_w)) * n_out
