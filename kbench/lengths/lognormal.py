"""Lognormal lengths: the ``(i + 0.5) / n`` quantiles of ``median`` x
exp(``sigma`` x N(0, 1)), rounded and clipped to ``[min, max]``."""

import math
from statistics import NormalDist


def draw(spec: dict, n: int, rng) -> list[int]:
    out = []
    for i in range(n):
        v = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf((i + 0.5) / n))
        out.append(int(min(spec["max"], max(spec["min"], round(v)))))
    return out
