"""K-Means codebook learning (port of ``repro/core/codebook.py``).

Scalar K-Means with deterministic quantile initialisation and a fixed number
of Lloyd iterations. Two departures from the JAX formulation, both forced by
full-width weight matrices (``mlp/wi`` of llama3_2_1b has 33.5 M entries):

* ``quantile_init`` sorts and interpolates linearly itself, with the same
  float32 arithmetic as ``jnp.quantile``'s ``linear`` method, because
  ``torch.quantile`` refuses inputs of that size;
* a Lloyd step assigns through the decision boundaries (``searchsorted``)
  and accumulates with ``bincount`` instead of an (S, C) one-hot matrix,
  which would hold 33.5 M x 16 (W4) or 16.8 M x 256 (W8) floats. Boundary
  assignment equals nearest-centroid ``argmin`` except for values that sit
  exactly on a midpoint, so fitted codebooks agree with the JAX ones to
  float tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

__all__ = [
    "assign",
    "quantile_init",
    "kmeans_fit",
    "boundaries_from_centroids",
    "assign_via_boundaries",
]


def _sorted_quantiles(xs: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(x, qs)`` ('linear') of an already sorted 1-D ``xs``."""
    n = xs.shape[0]
    q = qs * torch.tensor(float(n), dtype=torch.float32, device=xs.device).sub(1.0)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    lo_i = low.clamp(0, n - 1).long()
    hi_i = high.clamp(0, n - 1).long()
    return xs[lo_i] * low_w + xs[hi_i] * high_w


def quantile_init(x: torch.Tensor, n_centroids: int,
                  w: torch.Tensor | None = None) -> torch.Tensor:
    """Centroids at evenly spaced (weighted) quantiles of ``x``.

    Weighted: sort by value and take the first value whose normalized
    cumulative weight reaches each quantile, as the JAX package does."""
    x = x.reshape(-1).float()
    qs = (torch.arange(n_centroids, dtype=torch.float32, device=x.device) + 0.5) / n_centroids
    if w is None:
        return _sorted_quantiles(torch.sort(x).values, qs)
    xs, order = torch.sort(x, stable=True)
    cw = torch.cumsum(w.reshape(-1).float()[order], dim=0)
    cw = cw / torch.clamp(cw[-1], min=1e-30)
    pos = torch.searchsorted(cw, qs)
    return xs[pos.clamp(0, x.shape[0] - 1)]


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment (Eq. 1): int32 indices, the shape of x.
    Centroids need not be sorted; among equidistant centroids the first
    wins, as ``argmin`` picks it."""
    d = torch.abs(x[..., None] - centroids)
    return torch.argmin(d, dim=-1).to(torch.int32)


def boundaries_from_centroids(centroids: torch.Tensor) -> torch.Tensor:
    """Decision boundaries ``b_i = (c_i + c_{i+1}) / 2`` of sorted centroids."""
    return 0.5 * (centroids[:-1] + centroids[1:])


def assign_via_boundaries(x: torch.Tensor, sorted_centroids: torch.Tensor) -> torch.Tensor:
    """Index ``i`` for ``x`` in ``[b_{i-1}, b_i)``: ``searchsorted(side='right')``."""
    b = boundaries_from_centroids(sorted_centroids).contiguous()
    return torch.searchsorted(b, x.contiguous(), right=True).int()


def kmeans_fit(x: torch.Tensor, n_centroids: int, w: torch.Tensor | None = None,
               iters: int = 25) -> torch.Tensor:
    """Sorted float32 1-D K-Means codebook of ``n_centroids`` entries.

    Lloyd's algorithm from the (weighted) quantile initialisation; an empty
    cluster keeps its previous centroid. ``w`` holds per-sample (Fisher)
    weights, clamped at 1e-12 as in JAX. Cluster sums accumulate in
    float64, so the order a device's atomics add in moves a centroid by far
    less than a float32 ulp.
    """
    xf = x.reshape(-1).float()
    x64 = xf.double()
    wf = None if w is None else torch.clamp(w.reshape(-1).float(), min=1e-12)
    w64 = None if wf is None else wf.double()  # None: plain counts, exact in float64
    c = torch.sort(quantile_init(xf, n_centroids, wf)).values
    for _ in range(iters):
        idx = assign_via_boundaries(xf, c).long()
        wsum = torch.bincount(idx, weights=w64, minlength=n_centroids).double()
        wx = torch.bincount(idx, weights=x64 if w64 is None else w64 * x64,
                            minlength=n_centroids)
        new = torch.where(wsum > 0, (wx / wsum.clamp(min=1e-30)).float(), c)
        c = torch.sort(new).values
    return c
