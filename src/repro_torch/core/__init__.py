"""K-Means dual-side quantization, LUT-GEMM and outlier compensation (port of
``repro.core``)."""
