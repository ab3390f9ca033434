"""Offline calibration (port of ``repro/core/calibration.py``): activation
capture, Fisher weights, codebook fitting.

Quantizable projections call :func:`tap` on their input activations
(``models.layers.dense_apply``). Outside a capture it is an identity.
Inside :func:`capture` it records the activations per tap name; a name is
projection-scoped (``attn.q``, ``mlp.wd``, ``mamba.in_proj``, ...), so every
layer's activations pool under one name, as JAX's unrolled capture pools
them. :func:`captured` concatenates them per name, in the order recorded.

Fisher: the empirical Fisher diagonal of an activation x is E[(dL/dx)^2].
:func:`fisher_capture` adds a zero float32 perturbation (with
``requires_grad``) at every tap of a forward and differentiates the loss
with respect to it, so the gradient is dL/dx, summed over the layers that
share the name. JAX's ``dense_apply`` taps only concrete arrays, so under
``jax.grad`` only the taps before the first perturbed one fire there; the
port perturbs every tap (the tests hold it against JAX's ``dense_apply``
with that guard lifted). A remat forward (``TransformerLM``) runs each
block's recompute in the context of its forward, so the recompute's taps
read the same perturbations on autograd's own thread.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import torch

from repro_torch.core import quantize as qz
from repro_torch.device import resolve_device

__all__ = ["tap", "capture", "captured", "fisher_capture", "calibrate_codebooks"]

_CAPTURE: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_torch_calibration_capture", default=None)
_EPS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "repro_torch_calibration_eps", default=None)


def tap(name: str, x: torch.Tensor) -> torch.Tensor:
    """Mark ``x`` as the input activation of quantizable layer ``name``.

    Identity outside calibration. Inside :func:`capture`, records a detached
    copy of ``x`` as (tokens, K) on its device; inside
    :func:`fisher_capture`'s forward, adds the named zero perturbation so
    its gradient is dL/dx."""
    eps = _EPS.get()
    if eps is not None and name in eps:
        x = x + eps[name].to(x.dtype)
    store = _CAPTURE.get()
    if store is not None:
        store.setdefault(name, []).append(x.detach().reshape(-1, x.shape[-1]).clone())
    return x


@contextlib.contextmanager
def capture():
    """Record every tapped activation. Yields the store dict."""
    store: dict[str, list] = {}
    token = _CAPTURE.set(store)
    try:
        yield store
    finally:
        _CAPTURE.reset(token)


def captured(store: dict[str, list]) -> dict[str, torch.Tensor]:
    """A capture store as one (tokens, K) tensor per tap name."""
    return {k: torch.cat(vs, dim=0) for k, vs in store.items()}


def fisher_capture(loss_fn: Callable[[], torch.Tensor],
                   eps_shapes: dict[str, tuple[int, ...]],
                   device=None) -> dict[str, torch.Tensor]:
    """Per-element Fisher proxy (dL/dx)^2 at every tap point.

    ``loss_fn`` runs the tapped forward (closing over params and batch);
    ``eps_shapes`` gives the activation shape at each tap. Returns the
    squared gradients per tap name (float32, on ``device``: the card unless
    the caller names another)."""
    device = resolve_device(device)
    zeros = {k: torch.zeros(s, dtype=torch.float32, device=device, requires_grad=True)
             for k, s in eps_shapes.items()}
    names = list(zeros)
    token = _EPS.set(zeros)
    try:
        with torch.enable_grad():
            loss = loss_fn()
    finally:
        _EPS.reset(token)
    grads = torch.autograd.grad(loss, [zeros[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(zeros[k]) if g is None else torch.square(g)
            for k, g in zip(names, grads)}


def calibrate_codebooks(acts: dict[str, torch.Tensor], a_bits: int = 4,
                        fisher: dict[str, torch.Tensor] | None = None,
                        scale_mode: qz.ScaleMode = "rms") -> dict[str, torch.Tensor]:
    """Fit one offline activation codebook per captured layer (Fisher-weighted
    where ``fisher`` has the layer)."""
    out = {}
    for name, x in acts.items():
        f = None if fisher is None else fisher.get(name)
        if f is not None:
            f = f.reshape(-1, x.shape[-1])[: x.shape[0]]
        out[name] = qz.fit_activation_codebook(x, nbits=a_bits, fisher=f, scale_mode=scale_mode)
    return out
