"""Poisson arrivals: exponential gaps, the ``(i + 0.5) / n`` quantiles of
the unit exponential (the generator puts them in the mix's order). This
is vLLM's ``benchmark_serving.py --request-rate R`` at its default
``--burstiness 1.0``."""

import math

OPEN = True


def gaps(spec: dict, n: int, rng) -> list[float]:
    return [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
