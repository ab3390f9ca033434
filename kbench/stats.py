"""The arithmetic of the end-to-end metrics, on the harness's own clock."""

from __future__ import annotations

import statistics

__all__ = ["percentile", "ttft_values", "itl_values", "spread"]


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    r = (len(xs) - 1) * q / 100.0
    lo = int(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


def ttft_values(due: dict[int, float], first: dict[int, float], t0: float,
                t1: float) -> list[float]:
    """Time to first token of every request due in ``[t0, t1)``, from its
    due time; one still without a token at ``t1`` counts its wait so far."""
    return [min(first.get(rid, t1), t1) - d for rid, d in due.items() if t0 <= d < t1]


def itl_values(token_times: dict[int, list[float]], t0: float, t1: float) -> list[float]:
    """Every gap between two consecutive tokens of a request that ends in
    ``[t0, t1]``."""
    out = []
    for ts in token_times.values():
        out += [b - a for a, b in zip(ts, ts[1:]) if t0 <= b <= t1]
    return out


def spread(values: list[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
