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
gathered outlier values, so no activation index matrix is ever
materialised; with ``comp_mode="auto"`` (and float32 compute) the
compensation there is one sparse kernel (``kernels.ops.outlier_compensate``),
which adds ``r @ W~[outlier_channels, :]`` into y from the packed weight rows
at the outlier channels: no dense residual matrix, no dequantized weight, no
float GEMM. Explicit ``gather`` / ``scatter`` and the plain GEMM route keep the
JAX package's dense compensation (``core/outlier.py``), ``auto`` choosing
between them by the token count there.

Where the JAX package demotes a kernel route to plain code the port does
the same, on every device, counted and warned once: activation codebooks
above 16 entries take the plain GEMM route (the fused kernel's in-tile
bucketize stops at A4; dynamic detection still launches the detection-only
top-k kernel), and a kernel detection route under static detection scores
against the thresholds in plain code. No kernel exists for either in the
JAX package.

Region boundaries (``serving.telemetry.region``, mapped only when a fenced
packed step is captured): ``qlinear.main`` (the fused LUT-GEMM, or quantize plus the plain
LUT-GEMM), ``qlinear.detect`` (the float cast and the top-k, or the
streaming kernel), ``qlinear.residual`` (``r = x - q(x)`` at the outliers,
and the scatter route's dense residual matrix), ``qlinear.comp_dequant`` and
``qlinear.comp_matmul`` (``core/outlier.py``; the product and its add into
``y``; the sparse kernel runs in ``comp_matmul``, its residuals with it, and
leaves ``comp_dequant`` empty); the bias and the output cast count to
``other``.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
from typing import Literal

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import repro_torch.core.kernel_routing as kr
import repro_torch.core.numerics as nx
import repro_torch.core.outlier as ol
import repro_torch.core.quantize as qz
from repro_torch.core.lut_gemm import lut_gemm as _lut_gemm_plain
from repro_torch.serving.telemetry import region

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
    probe: bool = True  # emit quality probes when a numerics collector is active

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
                  cfg: QLinearConfig | None = None, *, k0: int = 0,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Dual-branch forward; the output dtype follows ``x`` unless given.

    ``k0``: the weight holds input channels ``[k0, k0 + K')`` of the ``K``
    that ``x`` has (a row-parallel shard). Then the token scale and the
    outlier detection run over the whole row, as unsharded, and the
    indices, the main branch and the compensation of the outliers that fall
    among these channels over the window: a partial sum over it. The routes
    are the unsharded layer's; the quality probes run on whole layers only."""
    if isinstance(p, QLinear):
        p = p.params
    cfg = p.cfg if cfg is None else cfg.validate()
    if isinstance(x, DTensor) or isinstance(p.qw.packed, DTensor):
        return _qlinear_sharded(p, x, cfg)
    k1 = k0 + p.qw.shape[0]
    window = (k0, k1) != (0, x.shape[-1])
    out_dtype = x.dtype if out_dtype is None else out_dtype
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
    region("qlinear.main")
    # the token scale once, over the whole row: the fused GEMM's and the
    # outlier residuals'; a window's indices take the whole row's scale
    scale = qz.token_scale(x, cfg.scale_mode) if window or route == "pallas" else None
    xw = x[..., k0:k1] if window else x
    qa = None
    outs = None
    if route == "pallas":
        from repro_torch.kernels import ops as kops

        y = kops.lut_gemm_fused(xw, p.act_codebook, p.qw, scale_mode=cfg.scale_mode,
                                out_dtype=cfg.compute_dtype, scale=scale)
    else:
        if detect_route == "pallas" and cfg.detection == "dynamic" and a_nbits <= 4:
            from repro_torch.kernels import ops as kops

            # the streaming kernel: indices and outlier set from one read
            region("qlinear.detect")
            qa, outs = kops.quantize_outlier_streaming(x, p.act_codebook, k_out,
                                                       cfg.scale_mode)
            region("qlinear.main")
            if window:
                qa = dataclasses.replace(qa, idx=qa.idx[..., k0:k1])
        else:
            qa = qz.quantize_activation(xw, p.act_codebook, cfg.scale_mode, scale=scale)
        y = _lut_gemm_plain(qa, p.qw, out_dtype=cfg.compute_dtype,
                            compute_dtype=cfg.compute_dtype)

    # ---- outlier branch ----------------------------------------------------
    if cfg.detection == "static_dense" and cfg.outlier_frac > 0:
        region("qlinear.residual")
        if qa is None:
            qa = qz.quantize_activation(xw, p.act_codebook, cfg.scale_mode, scale=scale)
        deq = qz.dequantize_activation(qa, dtype=cfg.compute_dtype)
        xf = xw.to(cfg.compute_dtype)
        region("qlinear.detect")
        mask = (xf > p.thr_hi) | (xf < p.thr_lo)
        region("qlinear.residual")
        r = torch.where(mask, xf - deq, torch.zeros_like(xf))
        region("qlinear.comp_dequant")
        w = p.qw.dequantize_rows().to(cfg.compute_dtype)
        region("qlinear.comp_matmul")
        y = y + r @ w
    elif cfg.detection != "none" and cfg.outlier_frac > 0:
        if outs is None:  # else the streaming kernel detected them
            region("qlinear.detect")
            if cfg.detection == "dynamic" and detect_route == "pallas":
                from repro_torch.kernels import ops as kops

                outs = kops.topk_outlier(x.float(), k_out)
            elif cfg.detection == "dynamic":
                outs = ol.detect_outliers_topk(x.float(), k_out)
            else:
                outs = ol.detect_outliers_static(x.float(), p.thr_lo, p.thr_hi, k_out)
        if window:  # the outliers among the window's channels, at their rows
            here = ((outs.channels >= k0) & (outs.channels < k1)).to(outs.mask.dtype)
            outs = ol.OutlierSet(values=outs.values, mask=outs.mask * here,
                                 channels=torch.clamp(outs.channels - k0, 0, k1 - k0 - 1))
        region("qlinear.residual")
        mode = cfg.comp_mode
        if mode == "auto" and route == "pallas" and cfg.compute_dtype == torch.float32:
            mode = "kernel"
        elif mode == "auto":
            mode = "gather" if _tokens(x) <= cfg.comp_auto_tokens else "scatter"
        kr.record_comp_route(mode)
        if mode == "kernel":
            from repro_torch.kernels import ops as kops

            # residuals and products in one sparse pass, added into y in place;
            # the dense routes' boundaries stay, comp_dequant empty
            region("qlinear.comp_dequant")
            region("qlinear.comp_matmul")
            y = kops.outlier_compensate(y, outs, scale, p.act_codebook, p.qw, mul_form=mul_form)
        else:
            if qa is None:
                r = ol.outlier_residuals_direct(outs, scale, p.act_codebook, mul_form=mul_form)
            else:
                r = ol.outlier_residuals(outs, qa)
            comp = (ol.compensate_gather(r, outs, p.qw, cfg.compute_dtype) if mode == "gather"
                    else ol.compensate_scatter(r, outs, p.qw, cfg.compute_dtype))
            y = y + comp
    region("other")

    if cfg.probe and nx.collecting() and not window:
        # quality probes (the quality telemetry level only): reductions on
        # the intermediates above; y is never touched
        nx.probe_qlinear(p, x, qa=qa, outs=outs, k_out=k_out,
                         dynamic=cfg.detection == "dynamic" and cfg.outlier_frac > 0,
                         scale_mode=cfg.scale_mode, tier=tier)

    if p.bias is not None:
        y = y + p.bias.to(cfg.compute_dtype)
    return y.to(out_dtype)


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _qlinear_sharded(p: QLinearParams, x: torch.Tensor, cfg: QLinearConfig) -> torch.Tensor:
    """:func:`qlinear_apply` on DTensors (a sharded serving step), one local
    site: DTensor has no rules for the nibble unpacking, the codebook
    gathers or the top-k. Each rank takes its own token rows of x with the
    channel dim whole (gathered: the token scale and the outlier detection
    must see the whole row, as in JAX) and runs :func:`qlinear_apply` on
    its shard of the weight, on the unsharded layer's routes. A weight
    sharded on its output channels ("model", column-parallel) gives each
    rank its own columns, a ``Shard`` of the output. One sharded on its
    input channels (row-parallel) gives each rank the partial sum over its
    own channels (``k0``), reduced here in ``compute_dtype``, with the
    bias added on the first shard only."""
    ref = x if isinstance(x, DTensor) else p.qw.packed
    mesh = ref.device_mesh
    rows = ([pl if isinstance(pl, Shard) and pl.dim < x.ndim - 1 else Replicate()
             for pl in x.placements] if isinstance(x, DTensor) else [Replicate()] * mesh.ndim)
    xl = x.redistribute(mesh, rows).to_local() if isinstance(x, DTensor) else x
    wpl = list(p.qw.packed.placements) if isinstance(p.qw.packed, DTensor) else []
    col = [i for i, pl in enumerate(wpl) if isinstance(pl, Shard) and pl.dim == 1]
    row = [i for i, pl in enumerate(wpl) if isinstance(pl, Shard) and pl.dim == 0]
    if len(col) + len(row) > 1:
        raise NotImplementedError(f"a quantized weight sharded as {wpl}: one mesh dim "
                                  "over its input or its output channels only")
    k, n = p.qw.shape
    packed = _local(p.qw.packed)
    per_byte = 2 if p.qw.nbits <= 4 else 1
    coord = mesh.get_coordinate()
    shape = (*x.shape[:-1], n)
    stride = torch.empty(shape, device="meta").stride()
    out = rows.copy()
    bias = _local(p.bias)
    k0 = 0
    if row:
        out[row[0]] = Partial()
        k, k0 = packed.shape[0], coord[row[0]] * packed.shape[0]
        bias = bias if coord[row[0]] == 0 else None
    n_local = packed.shape[1] * per_byte
    if col:
        out[col[0]] = Shard(len(shape) - 1)
        if bias is not None and bias.shape[-1] != n_local:
            bias = bias[..., coord[col[0]] * n_local : (coord[col[0]] + 1) * n_local]
    qw = qz.QuantizedWeight(packed=packed, codebook=_local(p.qw.codebook),
                            scale=_local(p.qw.scale), shape=(k, n_local), nbits=p.qw.nbits)
    local = QLinearParams(qw=qw, act_codebook=_local(p.act_codebook), bias=bias,
                          thr_lo=_local(p.thr_lo), thr_hi=_local(p.thr_hi), cfg=cfg)
    y = qlinear_apply(local, xl, cfg, k0=k0,
                      out_dtype=cfg.compute_dtype if row else None)
    y = DTensor.from_local(y, mesh, out, run_check=False, shape=shape, stride=stride)
    return y.redistribute(mesh, rows).to(x.dtype) if row else y
