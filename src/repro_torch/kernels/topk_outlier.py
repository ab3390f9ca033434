"""Orizuru dual top-k: CUDA kernel wrapper and its plain version.

Replaces ``repro/kernels/topk_outlier.py::topk_outlier_kernel_call``. The
kernel is ``repro_torch/csrc/topk_outlier.cu``; :func:`topk_outlier_plain` is
the port of ``repro/kernels/ref.py::topk_outlier_ref``, with a stable sort so
that ties go to the lowest channel as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["topk_outlier_call", "topk_outlier_plain"]

NAME = "topk_outlier"


def topk_outlier_plain(x: torch.Tensor, k: int):
    """(hi_vals desc, hi_idx, lo_vals asc, lo_idx), each (M, k)."""
    if x.is_cuda:
        build.PLAIN_ON_CUDA[NAME] += 1
    if not 1 <= k <= x.shape[-1]:
        raise ValueError(f"k={k} must be in [1, N={x.shape[-1]}]")
    hv, hi = torch.sort(x, dim=-1, descending=True, stable=True)
    lv, li = torch.sort(x, dim=-1, stable=True)
    return hv[..., :k], hi[..., :k].int(), lv[..., :k], li[..., :k].int()


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
    if n * 5 > 227 * 1024:
        raise ValueError(f"{NAME}: a row of N={n} does not fit in shared memory")
    hv = torch.empty((m, k), dtype=torch.float32, device=x.device)
    lv = torch.empty_like(hv)
    hi = torch.empty((m, k), dtype=torch.int32, device=x.device)
    li = torch.empty_like(hi)
    fn = build.library(NAME).topk_outlier
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, p, p, p, p, p]
    err = fn(x.data_ptr(), m, n, k, hv.data_ptr(), hi.data_ptr(), lv.data_ptr(),
             li.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return hv, hi, lv, li
