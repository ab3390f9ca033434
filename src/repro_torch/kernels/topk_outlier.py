"""Orizuru detection kernels: CUDA kernel wrappers and their plain versions.

* :func:`topk_outlier_call` replaces
  ``repro/kernels/topk_outlier.py::topk_outlier_kernel_call`` (kernel
  ``repro_torch/csrc/topk_outlier.cu``); :func:`topk_outlier_plain` is the
  port of ``repro/kernels/ref.py::topk_outlier_ref``.
* :func:`streaming_quantize_outlier_call` replaces
  ``streaming_quantize_outlier_kernel_call`` (kernel
  ``repro_torch/csrc/streaming_quantize_outlier.cu``): the activation indices
  and the dual top-k from one read of each row;
  :func:`streaming_quantize_outlier_plain` is the port of
  ``ref.streaming_quantize_outlier_ref``.

The plain versions sort :func:`order_key` (``core/outlier.py``) stably,
so ties go to the lowest channel as ``lax.top_k`` orders them; -0.0 ties
with +0.0 (the JAX Pallas kernel's order), and every NaN ranks above +inf
on the hi side and last on the lo side, on every device. The kernels select
by the same 32-bit key (``csrc/topk_select.cuh``), and both return x's own
bits.
"""

from __future__ import annotations

import torch

from repro_torch.core.outlier import order_key, stable_topk
from repro_torch.core.quantize import bucketize_mul_form
from repro_torch.kernels import build
from repro_torch.kernels.bucketize import rank

__all__ = ["topk_outlier_call", "topk_outlier_plain", "streaming_quantize_outlier_call",
           "streaming_quantize_outlier_plain", "order_key", "smem_bytes"]

NAME = "topk_outlier"
STREAMING = "streaming_quantize_outlier"
THREADS = 512  # threads of a row's block (csrc/topk_select.cuh)
MAX_N = 65535  # the selection packs two per-row counts into one 32-bit word
SMEM_LIMIT = 224 * 1024  # dynamic shared memory a block may take beside its static part


def smem_bytes(n: int, k: int) -> int:
    """Dynamic shared memory of one row's block (``topk_select.cuh::smem_bytes``):
    the row's keys, ceil(n / THREADS) per thread at a padded stride, then two
    lists of k 8-byte composites."""
    per = -(-n // THREADS)
    stride = THREADS + (1 if per >= 32 else 32 // per)
    return -(-per * stride * 4 // 8) * 8 + 16 * k


def _check_fits(name: str, n: int, k: int) -> None:
    if n > MAX_N or smem_bytes(n, k) > SMEM_LIMIT:
        raise ValueError(f"{name}: a row of N={n} with k={k} does not fit in shared memory "
                         f"(N <= {MAX_N} and {smem_bytes(n, k)} bytes <= {SMEM_LIMIT})")


def _dual_topk(x: torch.Tensor, k: int):
    if not 1 <= k <= x.shape[-1]:
        raise ValueError(f"k={k} must be in [1, N={x.shape[-1]}]")
    return (*stable_topk(x, k, largest=True), *stable_topk(x, k, largest=False))


def topk_outlier_plain(x: torch.Tensor, k: int):
    """(hi_vals desc, hi_idx, lo_vals asc, lo_idx), each (M, k)."""
    if x.is_cuda:
        build.PLAIN_ON_CUDA[NAME] += 1
    return _dual_topk(x, k)


def streaming_quantize_outlier_plain(x: torch.Tensor, scale: torch.Tensor,
                                     boundaries: torch.Tensor, k: int, *,
                                     mul_form: bool = False):
    """(idx int32 (M, N), hi_vals desc, hi_idx, lo_vals asc, lo_idx): the
    indices in the compare form ``mul_form`` selects, the top-k of raw x."""
    if x.is_cuda:
        build.PLAIN_ON_CUDA[STREAMING] += 1
    if mul_form:
        idx = bucketize_mul_form(x, scale, boundaries, dtype=torch.int32)
    else:
        idx = rank(x / scale, boundaries)
    return (idx, *_dual_topk(x, k))


def topk_outlier_call(x: torch.Tensor, k: int):
    """x (M, N) float32. CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{NAME}: x must be a contiguous (M, N) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, N={n}]")
    if x.device.type == "cpu":
        return topk_outlier_plain(x, k)
    if not x.is_cuda:
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    _check_fits(NAME, n, k)
    hv = torch.empty((m, k), dtype=torch.float32, device=x.device)
    lv = torch.empty_like(hv)
    hi = torch.empty((m, k), dtype=torch.int32, device=x.device)
    li = torch.empty_like(hi)
    fn = build.entry(NAME, "piiippppp")
    err = fn(x.data_ptr(), m, n, k, hv.data_ptr(), hi.data_ptr(), lv.data_ptr(),
             li.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return hv, hi, lv, li


def streaming_quantize_outlier_call(x: torch.Tensor, scale: torch.Tensor,
                                    boundaries: torch.Tensor, k: int, *,
                                    mul_form: bool = False):
    """x (M, N) float32, scale (M, 1) float32, boundaries (<= 15,) float32.
    A NaN gets index 0 in both compare forms (``kernels.bucketize``).
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{STREAMING}: x must be a contiguous (M, N) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, N={n}]")
    if tuple(scale.shape) != (m, 1) or scale.dtype != torch.float32:
        raise ValueError(f"{STREAMING}: scale must be float32 ({m}, 1), got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    nb = boundaries.shape[0]
    if boundaries.dim() != 1 or not 1 <= nb <= 15 or boundaries.dtype != torch.float32:
        raise ValueError(f"{STREAMING}: boundaries must be 1 to 15 float32 values (a_bits <= 4)")
    tensors = (x, scale, boundaries)
    if not all(t.device == x.device and t.is_contiguous() for t in tensors):
        raise ValueError(f"{STREAMING}: inputs must be contiguous on one device")
    if x.device.type == "cpu":
        return streaming_quantize_outlier_plain(x, scale, boundaries, k, mul_form=mul_form)
    if not x.is_cuda:
        raise ValueError(f"{STREAMING}: unsupported device {x.device}")
    _check_fits(STREAMING, n, k)
    idx = torch.empty((m, n), dtype=torch.int32, device=x.device)
    hv = torch.empty((m, k), dtype=torch.float32, device=x.device)
    lv = torch.empty_like(hv)
    hi = torch.empty((m, k), dtype=torch.int32, device=x.device)
    li = torch.empty_like(hi)
    fn = build.entry(STREAMING, "pppiiiiipppppp")
    err = fn(x.data_ptr(), scale.data_ptr(), boundaries.data_ptr(), nb, int(mul_form), m, n, k,
             idx.data_ptr(), hv.data_ptr(), hi.data_ptr(), lv.data_ptr(), li.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, STREAMING)
    build.LAUNCHES[STREAMING] += 1
    return idx, hv, hi, lv, li
