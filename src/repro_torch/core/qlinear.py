"""The dual-branch quantized linear layer (port of ``repro/core/qlinear.py``).

    y = LUT-GEMM(quantize(x), Wq)            # main branch, over every activation
      + r_outlier @ W~[outlier_channels, :]  # outlier branch (compensation)
      + bias

The main branch routes by ``QLinearConfig.kernel``: the ``pallas`` route runs
the fused quantize + LUT-GEMM kernel (activation indices never leave the
tile), ``jnp`` quantizes and runs the factorized product. Dynamic detection
routes by ``detect_kernel`` to the Orizuru kernels or a stable sort: beside
the fused GEMM the detection-only dual top-k kernel, beside the plain GEMM
the streaming kernel, which quantizes and detects in one read of the
activations. On the fused route the residuals are recomputed from the
gathered outlier values (``outlier_residuals_direct``), so no activation
index matrix is ever materialised.

Where the JAX package demotes a kernel route to plain code the port does
the same, on every device, counted and warned once: activation codebooks
above 16 entries take the plain GEMM route (the fused kernel's in-tile
bucketize stops at A4; dynamic detection still launches the detection-only
top-k kernel), and a kernel detection route under static detection scores
against the thresholds in plain code. No kernel exists for either in the
JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
from typing import Literal

import torch
from torch import nn

import repro_torch.core.kernel_routing as kr
import repro_torch.core.outlier as ol
import repro_torch.core.quantize as qz
from repro_torch.core.lut_gemm import lut_gemm as _lut_gemm_plain

__all__ = ["QLinearConfig", "QLinearParams", "QLinear", "qlinear_apply", "quantize_linear",
           "with_kernel_route", "with_detect_route"]

Detection = Literal["dynamic", "static", "static_dense", "none"]
CompMode = Literal["auto", "gather", "scatter"]
KernelRoute = Literal["auto", "pallas", "jnp"]


@dataclasses.dataclass(frozen=True)
class QLinearConfig:
    """Static configuration of a quantized linear layer (the JAX fields)."""

    w_bits: int = 4
    a_bits: int = 4
    method: str = "kmeans"
    outlier_frac: float = 0.005
    detection: Detection = "dynamic"
    comp_mode: CompMode = "auto"
    comp_auto_tokens: int = 64
    scale_mode: qz.ScaleMode = "rms"
    compute_dtype: object = torch.float32
    use_kernel: bool = False
    kernel: KernelRoute = "auto"
    detect_kernel: KernelRoute = "auto"
    probe: bool = True  # read from artifacts; quality probes are not ported yet

    def __post_init__(self):
        if self.kernel not in kr.ROUTES:
            raise ValueError(f"kernel must be one of {kr.ROUTES}, got {self.kernel!r}")
        if self.detect_kernel not in kr.ROUTES:
            raise ValueError(
                f"detect_kernel must be one of {kr.ROUTES}, got {self.detect_kernel!r}")
        if not 2 <= self.w_bits <= 8:
            raise ValueError(f"w_bits must be in [2, 8], got {self.w_bits}")
        if not 3 <= self.a_bits <= 8:
            raise ValueError(f"a_bits must be in [3, 8], got {self.a_bits}")

    def validate(self) -> "QLinearConfig":
        """Cross-field legality: the A3 K-Means tier needs online outliers."""
        if self.a_bits < 4 and self.detection == "none" and self.method == "kmeans":
            raise ValueError(
                f"a_bits={self.a_bits} (the A3 K-Means tier) requires online "
                "outlier compensation: set detection to 'dynamic', 'static', "
                "or 'static_dense' (A3 is only legal with detection != 'none')")
        return self


@dataclasses.dataclass(frozen=True)
class QLinearParams:
    """Quantized-linear tensors with their resolved apply-time config."""

    qw: qz.QuantizedWeight
    act_codebook: torch.Tensor
    bias: torch.Tensor | None
    thr_lo: torch.Tensor | None
    thr_hi: torch.Tensor | None
    cfg: QLinearConfig = QLinearConfig()


class QLinear(nn.Module):
    """``nn.Module`` form of :class:`QLinearParams`: the tensors are buffers,
    so ``.to(device)`` moves them, and ``forward`` is :func:`qlinear_apply`."""

    def __init__(self, p: QLinearParams):
        super().__init__()
        self.cfg = p.cfg
        self.qw_shape = tuple(p.qw.shape)
        self.qw_nbits = p.qw.nbits
        self.register_buffer("packed", p.qw.packed)
        self.register_buffer("codebook", p.qw.codebook)
        self.register_buffer("scale", p.qw.scale)
        self.register_buffer("act_codebook", p.act_codebook)
        for name in ("bias", "thr_lo", "thr_hi"):
            self.register_buffer(name, getattr(p, name))

    @property
    def params(self) -> QLinearParams:
        qw = qz.QuantizedWeight(packed=self.packed, codebook=self.codebook,
                                scale=self.scale, shape=self.qw_shape,
                                nbits=self.qw_nbits)
        return QLinearParams(qw=qw, act_codebook=self.act_codebook, bias=self.bias,
                             thr_lo=self.thr_lo, thr_hi=self.thr_hi, cfg=self.cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qlinear_apply(self.params, x)

    def extra_repr(self) -> str:
        k, n = self.qw_shape
        return f"K={k}, N={n}, w_bits={self.qw_nbits}, a_bits={self.cfg.a_bits}"


def quantize_linear(w: torch.Tensor, calib_acts: torch.Tensor, cfg: QLinearConfig,
                    bias: torch.Tensor | None = None,
                    fisher: torch.Tensor | None = None) -> QLinearParams:
    """PTQ of one ``(K, N)`` linear layer: weight K-Means plus an activation
    codebook fit on ``calib_acts`` (tokens, K), Fisher-weighted if given."""
    cfg.validate()
    qw = qz.quantize_weight(w, nbits=cfg.w_bits, method=cfg.method)
    book = qz.fit_activation_codebook(calib_acts, nbits=cfg.a_bits, fisher=fisher,
                                      scale_mode=cfg.scale_mode, method=cfg.method)
    thr_lo = thr_hi = None
    if cfg.detection in ("static", "static_dense"):
        thr_lo, thr_hi = ol.static_thresholds(calib_acts, cfg.outlier_frac)
    return QLinearParams(qw=qw, act_codebook=book, bias=bias, thr_lo=thr_lo,
                         thr_hi=thr_hi, cfg=cfg)


def _with_cfg(params, **change):
    """A copy of a QLinearParams or of a module tree whose QLinear configs
    take ``change``; tensors are shared, not copied."""
    if isinstance(params, QLinearParams):
        return dataclasses.replace(params, cfg=dataclasses.replace(params.cfg, **change))
    shared = itertools.chain(params.parameters(), params.buffers())
    out = copy.deepcopy(params, memo={id(t): t for t in shared})
    for m in out.modules():
        if isinstance(m, QLinear):
            m.cfg = dataclasses.replace(m.cfg, **change)
    return out


def with_kernel_route(params, kernel: KernelRoute):
    """``params`` with every GEMM route set to ``kernel`` and nothing
    re-quantized, so outputs stay comparable across routes."""
    return _with_cfg(params, kernel=kernel)


def with_detect_route(params, detect_kernel: KernelRoute):
    """``params`` with every detection route set to ``detect_kernel``."""
    return _with_cfg(params, detect_kernel=detect_kernel)


def _tokens(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1]) if x.ndim > 1 else 1


def qlinear_apply(p: QLinearParams | QLinear, x: torch.Tensor,
                  cfg: QLinearConfig | None = None) -> torch.Tensor:
    """Dual-branch forward; the output dtype follows ``x``."""
    if isinstance(p, QLinear):
        p = p.params
    cfg = p.cfg if cfg is None else cfg.validate()
    out_dtype = x.dtype
    a_nbits = int(p.act_codebook.shape[0]).bit_length() - 1
    tier = f"w{p.qw.nbits}a{a_nbits}"
    mul_form = x.dtype == torch.bfloat16

    route = kr.resolve_route(cfg.kernel, cfg.use_kernel, x.device)
    if route == "pallas" and a_nbits > 4:
        kr.record_fallback(tier, f"activation codebook has 2^{a_nbits} entries (> 16); "
                                 "fused bucketize supports a_bits <= 4")
        route = "jnp"
    kr.record_dispatch(tier, route)

    detect_route = None
    k_out = 0
    if cfg.detection != "none" and cfg.outlier_frac > 0:
        k_out = ol.num_outliers(x.shape[-1], cfg.outlier_frac)
        if cfg.detection == "dynamic":
            detect_route = kr.resolve_detect_route(cfg.detect_kernel, x.device)
            kr.record_detect_dispatch(tier, detect_route)
        else:
            detect_route = "jnp"
            if cfg.detect_kernel == "pallas":
                kr.record_detect_fallback(
                    tier, f"detection={cfg.detection!r} scores against static "
                          "thresholds (no top-k tournament); only 'dynamic' "
                          "routes to the Orizuru kernel")
            else:
                kr.record_detect_dispatch(tier, "jnp")

    # ---- main branch: LUT-GEMM over all activations ------------------------
    qa = None
    outs = None
    if route == "pallas":
        from repro_torch.kernels import ops as kops

        y = kops.lut_gemm_fused(x, p.act_codebook, p.qw, scale_mode=cfg.scale_mode,
                                out_dtype=cfg.compute_dtype)
    else:
        if detect_route == "pallas" and cfg.detection == "dynamic" and a_nbits <= 4:
            from repro_torch.kernels import ops as kops

            # the streaming kernel: indices and outlier set from one read
            qa, outs = kops.quantize_outlier_streaming(x, p.act_codebook, k_out,
                                                       cfg.scale_mode)
        else:
            qa = qz.quantize_activation(x, p.act_codebook, cfg.scale_mode)
        y = _lut_gemm_plain(qa, p.qw, out_dtype=cfg.compute_dtype,
                            compute_dtype=cfg.compute_dtype)

    # ---- outlier branch ----------------------------------------------------
    if cfg.detection == "static_dense" and cfg.outlier_frac > 0:
        if qa is None:
            qa = qz.quantize_activation(x, p.act_codebook, cfg.scale_mode)
        deq = qz.dequantize_activation(qa, dtype=cfg.compute_dtype)
        xf = x.to(cfg.compute_dtype)
        mask = (xf > p.thr_hi) | (xf < p.thr_lo)
        r = torch.where(mask, xf - deq, torch.zeros_like(xf))
        w = p.qw.dequantize_rows().to(cfg.compute_dtype)
        y = y + r @ w
    elif cfg.detection != "none" and cfg.outlier_frac > 0:
        if outs is None:  # else the streaming kernel detected them
            if cfg.detection == "dynamic" and detect_route == "pallas":
                from repro_torch.kernels import ops as kops

                outs = kops.topk_outlier(x.float(), k_out)
            elif cfg.detection == "dynamic":
                outs = ol.detect_outliers_topk(x.float(), k_out)
            else:
                outs = ol.detect_outliers_static(x.float(), p.thr_lo, p.thr_hi, k_out)
        if qa is None:
            r = ol.outlier_residuals_direct(outs, qz.token_scale(x, cfg.scale_mode),
                                            p.act_codebook, mul_form=mul_form)
        else:
            r = ol.outlier_residuals(outs, qa)
        mode = cfg.comp_mode
        if mode == "auto":
            mode = "gather" if _tokens(x) <= cfg.comp_auto_tokens else "scatter"
        kr.record_comp_route(mode)
        comp = (ol.compensate_gather(r, outs, p.qw, cfg.compute_dtype) if mode == "gather"
                else ol.compensate_scatter(r, outs, p.qw, cfg.compute_dtype))
        y = y + comp

    if p.bias is not None:
        y = y + p.bias.to(cfg.compute_dtype)
    return y.to(out_dtype)
