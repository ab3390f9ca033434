"""Activation clustering (the Clustering Unit): CUDA kernel wrapper and its plain version.

Replaces ``repro/kernels/bucketize.py::bucketize_kernel_call``. The kernel is
``repro_torch/csrc/bucketize.cu``; :func:`bucketize_plain` is the port of
``repro/kernels/ref.py::bucketize_ref``. Both return int32
``idx = sum_i [x >= b_i]``, the rank ``searchsorted(b, x, side='right')``
computes for sorted boundaries.

NaN passes no boundary: the kernels' compare sums give it index 0, and so do
the plain versions here, on every device. ``searchsorted`` itself, and with
it ``bucketize_ref`` and the float32 path of ``quantize_activation`` in both
packages, ranks NaN last (index ``len(b)``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["bucketize_call", "bucketize_plain", "rank"]

NAME = "bucketize"


def rank(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """``sum_i [x >= b_i]`` as int32: ``searchsorted(boundaries, x,
    side='right')`` with NaN at 0, as the compare sum gives it (uncounted:
    the index step inside other plain versions)."""
    r = torch.searchsorted(boundaries.contiguous(), x.contiguous(), right=True).int()
    return r.masked_fill_(torch.isnan(x), 0)


def bucketize_plain(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        build.PLAIN_ON_CUDA[NAME] += 1
    return rank(x, boundaries)


def bucketize_call(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32, boundaries (<= 255,) sorted float32 -> (M, K) int32;
    NaN gives 0.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{NAME}: x must be a contiguous (M, K) float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    nb = boundaries.shape[0]
    if (boundaries.dim() != 1 or not 1 <= nb <= 255 or boundaries.dtype != torch.float32
            or boundaries.device != x.device):
        raise ValueError(f"{NAME}: boundaries must be 1 to 255 float32 values on {x.device}")
    if x.device.type == "cpu":
        return bucketize_plain(x, boundaries)
    if not x.is_cuda:
        raise ValueError(f"{NAME}: unsupported device {x.device}")
    b = boundaries.contiguous()
    # idx at x's offset modulo 128 bytes, so the kernel's 16-byte loads and
    # stores line up and fill whole lines (x may be a view into a larger buffer)
    off = x.data_ptr() % 128 // 4
    idx = torch.empty(x.numel() + off, dtype=torch.int32, device=x.device)[off:].view(x.shape)
    fn = build.entry(NAME, "ppipqp")
    err = fn(x.data_ptr(), b.data_ptr(), nb, idx.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return idx
