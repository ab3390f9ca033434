"""PyTorch/CUDA port of the KLLM K-Means quantized inference system.

Mirrors the JAX package's layout (``configs``, ``core``, ``kernels``,
``models``, ``serving``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card and without an explicit device they
raise instead of running on the CPU.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
