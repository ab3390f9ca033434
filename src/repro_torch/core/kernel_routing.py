"""Kernel routing policy and dispatch accounting (port of ``repro/core/kernel_routing.py``).

Artifacts store the JAX route names, and the port reads them so:

  pallas : the hand-written kernel (``repro_torch/kernels``); on a CPU tensor
           its wrapper runs the kernel's plain PyTorch version instead
  jnp    : the plain PyTorch route (``core/lut_gemm.py``, stable-sort top-k)
  auto   : the kernel for CUDA tensors, the plain route for CPU tensors

PyTorch runs eagerly, so every counter here counts calls, not traces.
Fallbacks off a requested kernel route are counted and warned once per
reason, never silent.
"""

from __future__ import annotations

import warnings
from collections import Counter

import torch

__all__ = [
    "ROUTES",
    "resolve_route",
    "resolve_detect_route",
    "record_dispatch",
    "record_fallback",
    "record_detect_dispatch",
    "record_detect_fallback",
    "record_comp_route",
    "kernel_calls",
    "jnp_calls",
    "fallback_count",
    "detect_kernel_calls",
    "detect_jnp_calls",
    "detect_fallback_count",
    "comp_route_counts",
    "reset",
]

ROUTES = ("auto", "pallas", "jnp")

_DISPATCH: Counter = Counter()
_FALLBACKS: Counter = Counter()
_WARNED: set[str] = set()
_DETECT_DISPATCH: Counter = Counter()
_DETECT_FALLBACKS: Counter = Counter()
_COMP_ROUTES: Counter = Counter()


def _auto(device: torch.device) -> str:
    return "pallas" if device.type == "cuda" else "jnp"


def resolve_route(kernel: str, use_kernel: bool = False,
                  device: torch.device | str = "cpu") -> str:
    """Concrete GEMM route for a ``QLinearConfig.kernel`` policy on ``device``."""
    if kernel in ("pallas", "jnp"):
        return kernel
    if kernel != "auto":
        raise ValueError(f"kernel must be one of {ROUTES}, got {kernel!r}")
    if use_kernel:
        return "pallas"
    return _auto(torch.device(device))


def resolve_detect_route(detect_kernel: str, device: torch.device | str = "cpu") -> str:
    """Concrete detection route for a ``QLinearConfig.detect_kernel`` policy."""
    if detect_kernel in ("pallas", "jnp"):
        return detect_kernel
    if detect_kernel != "auto":
        raise ValueError(f"detect_kernel must be one of {ROUTES}, got {detect_kernel!r}")
    return _auto(torch.device(device))


def record_dispatch(tier: str, route: str) -> None:
    _DISPATCH[(tier, route)] += 1


def record_fallback(tier: str, reason: str) -> None:
    """Explicit kernel -> plain demotion: counted, warned once per reason."""
    _FALLBACKS[reason] += 1
    _DISPATCH[(tier, "fallback")] += 1
    if reason not in _WARNED:
        _WARNED.add(reason)
        warnings.warn(
            f"LUT-GEMM kernel route unavailable for tier {tier}: {reason}; "
            f"falling back to the plain factorized path",
            RuntimeWarning, stacklevel=3)


def record_detect_dispatch(tier: str, route: str) -> None:
    _DETECT_DISPATCH[(tier, route)] += 1


def record_detect_fallback(tier: str, reason: str) -> None:
    """Explicit detection kernel -> plain demotion: counted, warned once."""
    _DETECT_FALLBACKS[reason] += 1
    _DETECT_DISPATCH[(tier, "fallback")] += 1
    key = f"detect:{reason}"
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"Orizuru detection kernel route unavailable for tier {tier}: "
            f"{reason}; falling back to the plain (stable sort / threshold) path",
            RuntimeWarning, stacklevel=3)


def record_comp_route(mode: str) -> None:
    _COMP_ROUTES[mode] += 1


def kernel_calls() -> int:
    return sum(n for (_, r), n in _DISPATCH.items() if r == "pallas")


def jnp_calls() -> int:
    return sum(n for (_, r), n in _DISPATCH.items() if r == "jnp")


def fallback_count() -> int:
    return sum(_FALLBACKS.values())


def detect_kernel_calls() -> int:
    return sum(n for (_, r), n in _DETECT_DISPATCH.items() if r == "pallas")


def detect_jnp_calls() -> int:
    return sum(n for (_, r), n in _DETECT_DISPATCH.items() if r == "jnp")


def detect_fallback_count() -> int:
    return sum(_DETECT_FALLBACKS.values())


def comp_route_counts() -> dict[str, int]:
    return dict(sorted(_COMP_ROUTES.items()))


def reset() -> None:
    """Clear the counters (the one-time-warning set is kept)."""
    for c in (_DISPATCH, _FALLBACKS, _DETECT_DISPATCH, _DETECT_FALLBACKS, _COMP_ROUTES):
        c.clear()
