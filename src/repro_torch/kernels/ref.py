"""Plain PyTorch versions of the ported kernels, under the JAX oracle names
(``repro/kernels/ref.py``). Each lives beside its kernel's wrapper; this
module only gathers them for a reader coming from the JAX package."""

from repro_torch.kernels.bucketize import bucketize_plain as bucketize_ref
from repro_torch.kernels.lut_gemm import fused_lut_gemm_plain as fused_lut_gemm_ref
from repro_torch.kernels.lut_gemm import lut_gemm_plain as lut_gemm_ref
from repro_torch.kernels.paged_attn import paged_attn_plain as paged_attn_ref
from repro_torch.kernels.paged_attn import paged_attn_quant_plain as paged_attn_quant_ref
from repro_torch.kernels.topk_outlier import (
    streaming_quantize_outlier_plain as streaming_quantize_outlier_ref,
)
from repro_torch.kernels.topk_outlier import topk_outlier_plain as topk_outlier_ref

__all__ = ["bucketize_ref", "fused_lut_gemm_ref", "lut_gemm_ref", "paged_attn_ref",
           "paged_attn_quant_ref", "streaming_quantize_outlier_ref", "topk_outlier_ref"]
