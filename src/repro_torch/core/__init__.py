"""K-Means dual-side quantization, LUT-GEMM and outlier compensation (port of
``repro.core``): the public API, under the JAX package's names.

The modules that reach the kernels (``qlinear``, ``numerics``, and
``artifact`` and ``quantspec`` through them) load on first use (PEP 562):
the kernel wrappers import this package, and an eager import of them here
would close a cycle. ``lut_gemm`` names the module here, as everywhere in
the port (the plain GEMM is ``lut_gemm.lut_gemm``); JAX's package binds the
function over its module of the same name."""

import importlib

from repro_torch.core import codebook, kernel_routing, lut_gemm, outlier, quantize
from repro_torch.core.codebook import (assign, assign_via_boundaries, boundaries_from_centroids,
                                       kmeans_fit, quantile_init)
from repro_torch.core.lut_gemm import build_lut, lut_gemm_counting
from repro_torch.core.outlier import (OutlierSet, compensate_gather, compensate_scatter,
                                      detect_outliers_static, detect_outliers_topk, num_outliers,
                                      orizuru_comparisons, outlier_residuals, static_thresholds)
from repro_torch.core.quantize import (QuantizedActivation, QuantizedWeight,
                                       dequantize_activation, dequantize_weight,
                                       fit_activation_codebook, pack_int4, quantize_activation,
                                       quantize_weight, token_scale, unpack_int4)

_LAZY = {
    "QuantizedArtifact": ("artifact", "QuantizedArtifact"),
    "load_calib_stats": ("artifact", "load_calib_stats"),
    "load_quantized": ("artifact", "load_quantized"),
    "save_quantized": ("artifact", "save_quantized"),
    "QualityMonitor": ("numerics", "QualityMonitor"),
    "activation_stats": ("numerics", "activation_stats"),
    "drift_score": ("numerics", "drift_score"),
    "probe_qlinear": ("numerics", "probe_qlinear"),
    "collect_probes": ("numerics", "collect"),
    "QLinearConfig": ("qlinear", "QLinearConfig"),
    "QLinearParams": ("qlinear", "QLinearParams"),
    "qlinear_apply": ("qlinear", "qlinear_apply"),
    "quantize_linear": ("qlinear", "quantize_linear"),
    "QuantRule": ("quantspec", "QuantRule"),
    "QuantSpec": ("quantspec", "QuantSpec"),
    "quantize_model": ("models.model", "quantize_model"),
}
_LAZY_MODULES = ("artifact", "numerics", "qlinear", "quantspec")

__all__ = [
    "OutlierSet", "QLinearConfig", "QLinearParams", "QualityMonitor", "QuantRule", "QuantSpec",
    "QuantizedActivation", "QuantizedArtifact", "QuantizedWeight", "activation_stats",
    "artifact", "assign", "assign_via_boundaries", "boundaries_from_centroids", "build_lut",
    "codebook", "collect_probes", "compensate_gather", "compensate_scatter",
    "dequantize_activation", "dequantize_weight", "detect_outliers_static",
    "detect_outliers_topk", "drift_score", "fit_activation_codebook", "kernel_routing",
    "kmeans_fit", "load_calib_stats", "load_quantized", "lut_gemm", "lut_gemm_counting",
    "num_outliers", "numerics", "orizuru_comparisons", "outlier", "outlier_residuals",
    "pack_int4", "probe_qlinear", "qlinear", "qlinear_apply", "quantile_init", "quantize",
    "quantize_activation", "quantize_linear", "quantize_model", "quantize_weight", "quantspec",
    "save_quantized", "static_thresholds", "token_scale", "unpack_int4",
]


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f"repro_torch.core.{name}")
    if name in _LAZY:
        mod, attr = _LAZY[name]
        pkg = "repro_torch" if mod.startswith("models") else "repro_torch.core"
        return getattr(importlib.import_module(f"{pkg}.{mod}"), attr)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
