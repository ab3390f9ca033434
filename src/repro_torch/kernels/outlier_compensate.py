"""Sparse outlier compensation: the CUDA kernel wrapper and its plain version.

The kernel (``repro_torch/csrc/outlier_compensate.cu``) replaces no TPU
kernel: the JAX package leaves the compensation to ``jnp``
(``repro/core/outlier.py::compensate_gather`` / ``compensate_scatter``).
Both versions add into the main branch's float32 output, in place,

    y[m, n] += w_scale[n] * sum_t r[m, t] * w_book[idx[channels[m, t], n]]
    r[m, t]  = (values[m, t] - a_book[bucket(values[m, t], s[m])] * s[m]) * mask[m, t]

with the residuals recomputed from the outlier values as
``core.outlier.outlier_residuals_direct`` computes them (the bucket in the
compare form ``mul_form`` selects). :func:`outlier_compensate_plain` sums in
the kernel's order: each product rounded, the slots of a row in turn, then
one multiply by the channel scale and one add into y. So the kernel equals
it bit for bit, but for the sign of a zero (the kernel skips a slot whose
residual is exactly 0). Against the dense routes only the order of the
float32 sums differs.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import bucketize_mul_form
from repro_torch.kernels import build
from repro_torch.kernels.bucketize import rank

__all__ = ["outlier_compensate_call", "outlier_compensate_plain", "random_inputs"]

NAME = "outlier_compensate"


def _residuals(values, scale, boundaries, a_book, mask, *, mul_form: bool = False):
    """``r = (v - a_book[bucket(v, s)] * s) * mask`` (float32, the shape of
    ``values``), the bucket ``sum_i [v >= s * b_i]`` (``mul_form``) or
    ``sum_i [v / s >= b_i]``."""
    if mul_form:
        idx = bucketize_mul_form(values, scale, boundaries, dtype=torch.int32)
    else:
        idx = rank(values / scale, boundaries)
    return (values - a_book[idx.long()] * scale) * mask


def _centroids(rows: torch.Tensor, w_book: torch.Tensor, byte_packed: bool) -> torch.Tensor:
    """``w_book[idx]`` of packed weight rows, the codebook padded with zeros
    (to 256 entries for bytes, 16 for nibbles, low nibble first)."""
    full = torch.zeros(256 if byte_packed else 16, dtype=torch.float32, device=rows.device)
    full[: w_book.shape[0]] = w_book
    if byte_packed:
        return full[rows.long()]
    pairs = torch.stack([full[rows.long() & 0xF], full[rows.long() >> 4]], dim=-1)
    return pairs.reshape(*rows.shape[:-1], rows.shape[-1] * 2)


def outlier_compensate_plain(y, values, channels, mask, scale, boundaries, a_book, w_packed,
                             w_book, w_scale, *, byte_packed: bool = False,
                             mul_form: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: ``y`` updated in place and returned."""
    if y.is_cuda:
        build.PLAIN_ON_CUDA[NAME] += 1
    r = _residuals(values, scale, boundaries, a_book, mask, mul_form=mul_form)
    acc = torch.zeros_like(y)
    for t in range(r.shape[1]):
        rows = _centroids(w_packed[channels[:, t].long()], w_book, byte_packed)
        acc = acc + r[:, t : t + 1] * rows
    return y.add_(acc * w_scale)


def random_inputs(m: int, k: int, n: int, t: int, *, byte_packed: bool, mul_form: bool,
                  gen: torch.Generator, w_bits: int = 4) -> dict:
    """Keyword arguments of :func:`outlier_compensate_call` for ``m`` rows of
    ``t`` outlier slots into a (K, N) weight, drawn on ``gen``'s device:
    values a few token scales large (bfloat16 values for ``mul_form``),
    random channels, every seventh slot masked, and in every third row the
    last slot on the first slot's channel (a channel in both sets). The
    nibble tier's codebook has ``2 ** w_bits`` entries, the byte tier's 256."""
    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels.lut_gemm import random_packed
    from repro_torch.models.model import _default_codebook

    dev = gen.device
    a_book = _default_codebook(4, device=dev)
    values = torch.randn((m, t), generator=gen, device=dev) * 3
    if mul_form:
        values = values.to(torch.bfloat16).float()
    channels = torch.randint(0, k, (m, t), generator=gen, device=dev, dtype=torch.int32)
    channels[::3, -1] = channels[::3, 0]
    mask = torch.ones((m, t), device=dev)
    mask.view(-1)[::7] = 0.0
    n_w = 256 if byte_packed else 2**w_bits
    return dict(
        y=torch.randn((m, n), generator=gen, device=dev), values=values, channels=channels,
        mask=mask, scale=torch.rand((m, 1), generator=gen, device=dev) + 0.5,
        boundaries=boundaries_from_centroids(a_book).contiguous(), a_book=a_book,
        w_packed=random_packed(k, n, n_w, byte_packed, gen),
        w_book=torch.sort(torch.randn(n_w, generator=gen, device=dev)).values,
        w_scale=torch.rand(n, generator=gen, device=dev) * 0.02 + 0.01,
        byte_packed=byte_packed, mul_form=mul_form)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{NAME}: {msg}")


def outlier_compensate_call(y, values, channels, mask, scale, boundaries, a_book, w_packed,
                            w_book, w_scale, *, byte_packed: bool = False,
                            mul_form: bool = False) -> torch.Tensor:
    """y (M, N) float32, updated in place and returned; values, mask (M, T)
    float32; channels (M, T) int32 in [0, K); scale (M, 1) float32;
    boundaries (nb,) sorted and a_book (nb + 1,) float32; w_packed (K, N/2)
    or (K, N) uint8; w_book (<= 16 or <= 256,) and w_scale (N,) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    allocates nothing and may be captured in a CUDA graph.
    """
    m, n = y.shape
    t = values.shape[1] if values.dim() == 2 else -1
    _require(y.dtype == torch.float32, f"y must be float32, got {y.dtype}")
    _require(values.dim() == 2 and values.shape[0] == m and values.dtype == torch.float32,
             f"values must be float32 ({m}, T), got {values.dtype} {tuple(values.shape)}")
    _require(tuple(channels.shape) == (m, t) and channels.dtype == torch.int32,
             f"channels must be int32 ({m}, {t}), got {channels.dtype} {tuple(channels.shape)}")
    _require(tuple(mask.shape) == (m, t) and mask.dtype == torch.float32,
             f"mask must be float32 ({m}, {t}), got {mask.dtype} {tuple(mask.shape)}")
    _require(tuple(scale.shape) == (m, 1) and scale.dtype == torch.float32,
             f"scale must be float32 ({m}, 1), got {scale.dtype} {tuple(scale.shape)}")
    nb = boundaries.shape[0]
    _require(boundaries.dim() == 1 and 1 <= nb <= 255 and tuple(a_book.shape) == (nb + 1,),
             "boundaries must be 1 to 255 values and a_book one more")
    _require(w_packed.dtype == torch.uint8 and w_packed.dim() == 2
             and w_packed.shape[1] * (1 if byte_packed else 2) == n,
             f"w_packed must be uint8 with N={n} columns, got {w_packed.dtype} "
             f"{tuple(w_packed.shape)}")
    _require(1 <= w_book.shape[0] <= (256 if byte_packed else 16),
             "weight codebook must have <= 16 (nibble) or <= 256 (byte) entries")
    _require(tuple(w_scale.shape) == (n,), f"w_scale must be ({n},), got {tuple(w_scale.shape)}")
    tensors = (y, values, channels, mask, scale, boundaries, a_book, w_packed, w_book, w_scale)
    _require(all(a.device == y.device for a in tensors), "inputs must share one device")
    _require(all(a.is_contiguous() for a in tensors), "inputs must be contiguous")
    _require(all(a.dtype == torch.float32 for a in (boundaries, a_book, w_book, w_scale)),
             "boundaries, codebooks and scales must be float32")
    if y.device.type == "cpu":
        return outlier_compensate_plain(y, values, channels, mask, scale, boundaries, a_book,
                                        w_packed, w_book, w_scale, byte_packed=byte_packed,
                                        mul_form=mul_form)
    _require(y.is_cuda, f"unsupported device {y.device}")
    fn = build.entry(NAME, "ppppppipipipipiiip")
    err = fn(y.data_ptr(), values.data_ptr(), channels.data_ptr(), mask.data_ptr(),
             scale.data_ptr(), boundaries.data_ptr(), nb, a_book.data_ptr(), int(mul_form),
             w_packed.data_ptr(), int(byte_packed), w_book.data_ptr(), w_book.shape[0],
             w_scale.data_ptr(), m, n, t, torch.cuda.current_stream(y.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return y
