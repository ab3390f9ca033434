"""Dual-side K-Means quantization (port of ``repro/core/quantize.py``).

Weights: one learned codebook per matrix, per-output-channel absmax scale,
indices nibble-packed (W <= 4) or one per byte (W5-W8). Activations: an
offline codebook in per-token-normalised space plus a dynamic per-token
scale (the token RMS by default).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import codebook as cb

__all__ = [
    "QuantizedWeight",
    "QuantizedActivation",
    "pack_int4",
    "unpack_int4",
    "quantize_weight",
    "dequantize_weight",
    "token_scale",
    "quantize_activation",
    "dequantize_activation",
    "fit_activation_codebook",
]

ScaleMode = Literal["rms", "absmax"]


def pack_int4(idx: torch.Tensor) -> torch.Tensor:
    """``packed[..., i] = idx[..., 2i] | idx[..., 2i+1] << 4`` as uint8."""
    if idx.shape[-1] % 2:
        raise ValueError(f"last axis must be even for int4 packing, got {tuple(idx.shape)}")
    lo = idx[..., 0::2].to(torch.uint8)
    hi = idx[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`; int32 indices."""
    lo = (packed & 0xF).int()
    hi = (packed >> 4).int()
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """K-Means weight of logical shape ``shape = (K, N)``.

    packed   : uint8 (K, N//2) for nbits <= 4, (K, N) for nbits in 5..8
    codebook : float32 (2^nbits,) sorted centroids
    scale    : float32 (N,) per-output-channel scale
    """

    packed: torch.Tensor
    codebook: torch.Tensor
    scale: torch.Tensor
    shape: tuple[int, int]
    nbits: int

    def centroids(self, rows: torch.Tensor | None = None) -> torch.Tensor:
        """float32 ``codebook[idx]`` (unscaled) for all rows or the given ones.

        Gathers packed rows first, then looks up through a 256-entry table of
        (low, high) centroid pairs, so a full-width matrix never exists as
        int64 indices.
        """
        packed = self.packed if rows is None else self.packed[rows]
        book = self.codebook.float()
        if self.nbits > 4:
            return book[packed.long()]
        full = torch.zeros(16, dtype=torch.float32, device=book.device)
        full[: book.shape[0]] = book
        codes = torch.arange(256, device=book.device)
        pairs = torch.stack([full[codes & 0xF], full[codes >> 4]], dim=-1)
        return pairs[packed.long()].reshape(*packed.shape[:-1], packed.shape[-1] * 2)

    def dequantize_rows(self, rows: torch.Tensor | None = None) -> torch.Tensor:
        """float32 ``codebook[idx] * scale`` for all rows or the given ones."""
        return self.centroids(rows) * self.scale

    @property
    def indices(self) -> torch.Tensor:
        """Unpacked int32 index matrix, shape ``(K, N)``."""
        if self.nbits <= 4:
            return unpack_int4(self.packed)
        return self.packed.int()

    def hbm_bytes(self) -> int:
        """Bytes of the stored form: indices, codebook and channel scales."""
        k, n = self.shape
        idx_bytes = k * n // 2 if self.nbits <= 4 else k * n
        return idx_bytes + self.codebook.numel() * 4 + n * 4


@dataclasses.dataclass(frozen=True)
class QuantizedActivation:
    """Per-token activation indices (int32, or int8 from the bf16 form),
    per-token scale (..., 1) float32 and the shared codebook."""

    idx: torch.Tensor
    scale: torch.Tensor
    codebook: torch.Tensor
    nbits: int


def quantize_weight(w: torch.Tensor, nbits: int = 4, iters: int = 25,
                    method: str = "kmeans") -> QuantizedWeight:
    """PTQ of a ``(K, N)`` weight: absmax channel scale + one K-Means codebook."""
    k, n = w.shape
    if nbits > 8:
        raise ValueError(f"weight codebooks top out at 8 bits, got {nbits}")
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-12).float()
    wn = (w / scale[None, :]).float()
    if method == "kmeans":
        book = cb.kmeans_fit(wn, 2**nbits, iters=iters)
    elif method == "uniform":
        book = torch.linspace(-1.0, 1.0, 2**nbits, device=w.device)
    else:
        raise ValueError(method)
    idx = cb.assign_via_boundaries(wn, book)
    if nbits <= 4:
        if n % 2:
            raise ValueError("N must be even to nibble-pack along output channels")
        packed = pack_int4(idx)
    else:
        packed = idx.to(torch.uint8)
    return QuantizedWeight(packed=packed, codebook=book, scale=scale,
                           shape=(k, n), nbits=nbits)


def dequantize_weight(qw: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    """``W~[k, n] = C[idx[k, n]] * scale[n]``."""
    return qw.dequantize_rows().to(dtype)


def token_scale(x: torch.Tensor, mode: ScaleMode = "rms") -> torch.Tensor:
    """Per-token scale over the channel axis, shape ``(..., 1)``, float32.

    XLA and PyTorch reduce in different orders, so this can differ from the
    JAX value in the last ulp; kernel contracts take the scale as an input.
    """
    xf = x.float()
    if mode == "rms":
        s = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True))
    elif mode == "absmax":
        s = torch.amax(xf.abs(), dim=-1, keepdim=True)
    else:
        raise ValueError(mode)
    return torch.clamp(s, min=1e-12)


def bucketize_mul_form(x: torch.Tensor, scale: torch.Tensor,
                       boundaries: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """Sum of ``x >= s * b_i`` compares, the bf16 (fused) index form."""
    return (x.float()[..., None] >= scale[..., None] * boundaries).sum(-1).to(dtype)


def quantize_activation(x: torch.Tensor, codebook: torch.Tensor,
                        scale_mode: ScaleMode = "rms") -> QuantizedActivation:
    """bf16 inputs: int8 sum of compares against ``s * b_i``; float32 inputs:
    ``searchsorted`` of ``x / s`` (bit-equal to nearest-centroid argmin)."""
    s = token_scale(x, scale_mode)
    nbits = int(codebook.shape[0]).bit_length() - 1
    if x.dtype == torch.bfloat16:
        b = cb.boundaries_from_centroids(codebook)
        idx = bucketize_mul_form(x, s, b)
        return QuantizedActivation(idx=idx, scale=s, codebook=codebook, nbits=nbits)
    idx = cb.assign_via_boundaries((x / s).float(), codebook)
    return QuantizedActivation(idx=idx, scale=s, codebook=codebook, nbits=nbits)


def dequantize_activation(qa: QuantizedActivation, dtype=torch.float32) -> torch.Tensor:
    return (qa.codebook[qa.idx.long()] * qa.scale).to(dtype)


def fit_activation_codebook(samples: torch.Tensor, nbits: int = 4,
                            fisher: torch.Tensor | None = None,
                            scale_mode: ScaleMode = "rms", iters: int = 25,
                            method: str = "kmeans") -> torch.Tensor:
    """Offline activation codebook from (tokens, K) calibration activations,
    fit in per-token-normalised space; ``fisher`` (same shape) weights the
    K-Means. ``method="uniform"`` gives the evenly spaced baseline grid."""
    s = token_scale(samples, scale_mode)
    xn = (samples / s).float()
    if method == "uniform":
        lim = torch.amax(xn.abs()).item()
        return torch.linspace(-lim, lim, 2**nbits, device=xn.device)
    w = None if fisher is None else fisher.float()
    return cb.kmeans_fit(xn, 2**nbits, w=w, iters=iters)
