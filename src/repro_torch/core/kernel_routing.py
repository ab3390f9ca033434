"""Kernel routing policy and dispatch accounting (port of ``repro/core/kernel_routing.py``).

Artifacts store the JAX route names, and the port reads them so:

  pallas : the hand-written kernel (``repro_torch/kernels``); on a CPU tensor
           its wrapper runs the kernel's plain PyTorch version instead
  jnp    : the plain PyTorch route (``core/lut_gemm.py``, stable-sort top-k)
  auto   : the kernel for CUDA tensors, the plain route for CPU tensors

As in JAX, an environment variable changes what ``auto`` means:
``REPRO_LUT_KERNEL`` for the GEMM, ``REPRO_TOPK_KERNEL`` for dynamic
detection, ``REPRO_PAGED_KERNEL`` for paged attention. Unset, ``""`` or
``auto`` keeps the default; ``0``, ``off`` or ``false`` takes the plain route
on every device; anything else the kernel route (whose wrapper still runs
the plain version on a CPU tensor). Each variable is read once, at its
first use; :func:`reset_env` forgets the readings. A call that an override
sends to the plain route on a CUDA tensor is counted under the variable's
name in ``kernels.build.PLAIN_ON_CUDA``: the user asked for it, and it shows.

Every counter here counts calls, not traces. A captured CUDA graph replays
without Python, so the graph step adds what one captured run counted once
per replay (``serving/graph_step.py``); ``COUNTERS`` lists them for it.
Fallbacks off a requested kernel route are counted and warned once per
reason, never silent.
"""

from __future__ import annotations

import os
import warnings
from collections import Counter

import torch

from repro_torch.kernels import build

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
    "detect_calls",
    "detect_kernel_calls",
    "detect_jnp_calls",
    "detect_fallback_count",
    "comp_route_counts",
    "dispatch_counts",
    "detect_dispatch_counts",
    "snapshot",
    "reset",
    "resolve_paged_route",
    "reset_env",
    "COUNTERS",
]

ROUTES = ("auto", "pallas", "jnp")

_DISPATCH: Counter = Counter()
_FALLBACKS: Counter = Counter()
_WARNED: set[str] = set()
_DETECT_DISPATCH: Counter = Counter()
_DETECT_FALLBACKS: Counter = Counter()
_COMP_ROUTES: Counter = Counter()
COUNTERS = (_DISPATCH, _FALLBACKS, _DETECT_DISPATCH, _DETECT_FALLBACKS, _COMP_ROUTES)
_ENV_READ: dict[str, bool | None] = {}


def _env_override(var: str) -> bool | None:
    """The first reading of ``var``: None keeps the default, True forces the
    kernel route, False the plain route (JAX's spelling)."""
    if var not in _ENV_READ:
        env = os.environ.get(var, "auto").strip().lower()
        _ENV_READ[var] = None if env in ("", "auto") else env not in ("0", "off", "false")
    return _ENV_READ[var]


def reset_env() -> None:
    """Forget the readings of the route variables (the next use reads again)."""
    _ENV_READ.clear()


def _auto(device: torch.device, var: str) -> str:
    forced = _env_override(var)
    if forced is None:
        return "pallas" if device.type == "cuda" else "jnp"
    if not forced and device.type == "cuda":
        build.PLAIN_ON_CUDA[var] += 1
    return "pallas" if forced else "jnp"


def resolve_route(kernel: str, use_kernel: bool = False,
                  device: torch.device | str = "cpu") -> str:
    """Concrete GEMM route for a ``QLinearConfig.kernel`` policy on ``device``."""
    if kernel in ("pallas", "jnp"):
        return kernel
    if kernel != "auto":
        raise ValueError(f"kernel must be one of {ROUTES}, got {kernel!r}")
    if use_kernel:
        return "pallas"
    return _auto(torch.device(device), "REPRO_LUT_KERNEL")


def resolve_detect_route(detect_kernel: str, device: torch.device | str = "cpu") -> str:
    """Concrete detection route for a ``QLinearConfig.detect_kernel`` policy."""
    if detect_kernel in ("pallas", "jnp"):
        return detect_kernel
    if detect_kernel != "auto":
        raise ValueError(f"detect_kernel must be one of {ROUTES}, got {detect_kernel!r}")
    return _auto(torch.device(device), "REPRO_TOPK_KERNEL")


def resolve_paged_route(device: torch.device | str = "cpu") -> str:
    """Paged attention's route: ``auto`` under ``REPRO_PAGED_KERNEL``."""
    return _auto(torch.device(device), "REPRO_PAGED_KERNEL")


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
    """One compensation on route ``mode``: ``gather`` or ``scatter`` (the
    dense routes of both packages) or ``kernel`` (the port's sparse
    compensation kernel, which the JAX package does not have)."""
    _COMP_ROUTES[mode] += 1


def dispatch_counts() -> dict[str, int]:
    """``{"<tier>/<route>": count}`` of every recorded dispatch."""
    return {f"{tier}/{route}": n for (tier, route), n in sorted(_DISPATCH.items())}


def detect_dispatch_counts() -> dict[str, int]:
    """``{"<tier>/<route>": count}`` of the detection dispatches."""
    return {f"{tier}/{route}": n for (tier, route), n in sorted(_DETECT_DISPATCH.items())}


def kernel_calls() -> int:
    return sum(n for (_, r), n in _DISPATCH.items() if r == "pallas")


def jnp_calls() -> int:
    return sum(n for (_, r), n in _DISPATCH.items() if r == "jnp")


def fallback_count() -> int:
    return sum(_FALLBACKS.values())


def detect_calls() -> int:
    """Detection resolutions of every route, demotions included."""
    return sum(_DETECT_DISPATCH.values())


def detect_kernel_calls() -> int:
    return sum(n for (_, r), n in _DETECT_DISPATCH.items() if r == "pallas")


def detect_jnp_calls() -> int:
    return sum(n for (_, r), n in _DETECT_DISPATCH.items() if r == "jnp")


def detect_fallback_count() -> int:
    return sum(_DETECT_FALLBACKS.values())


def comp_route_counts() -> dict[str, int]:
    return dict(sorted(_COMP_ROUTES.items()))


def snapshot() -> dict[str, int]:
    """A flat copy of every counter, for delta-based checks."""
    d = dispatch_counts()
    for key, n in detect_dispatch_counts().items():
        d[f"detect:{key}"] = n
    for mode, n in comp_route_counts().items():
        d[f"comp:{mode}"] = n
    d["_kernel_calls"] = kernel_calls()
    d["_jnp_calls"] = jnp_calls()
    d["_fallbacks"] = fallback_count()
    d["_detect_calls"] = detect_calls()
    d["_detect_kernel_calls"] = detect_kernel_calls()
    d["_detect_jnp_calls"] = detect_jnp_calls()
    d["_detect_fallbacks"] = detect_fallback_count()
    return d


def reset() -> None:
    """Clear the counters (the one-time-warning set is kept)."""
    for c in (_DISPATCH, _FALLBACKS, _DETECT_DISPATCH, _DETECT_FALLBACKS, _COMP_ROUTES):
        c.clear()
