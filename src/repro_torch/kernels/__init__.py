"""Hand-written Hopper kernels (``repro_torch/csrc``), their ctypes wrappers
and their plain PyTorch versions. Wrappers run the plain version for CPU
tensors and launch the kernel for CUDA tensors; ``build.LAUNCHES`` counts
the launches."""
