"""Bursty arrivals: gamma gaps with the coefficient of variation ``cv``
(shape ``1 / cv**2``; ``cv`` 1 is Poisson, above 1 bursts), drawn from the
mix's schedule and scaled to a mean of exactly one. vLLM's
``benchmark_serving.py --burstiness b`` is ``cv = 1 / sqrt(b)``."""

OPEN = True


def gaps(spec: dict, n: int, rng) -> list[float]:
    shape = 1.0 / float(spec["cv"]) ** 2
    g = rng.gamma(shape, 1.0 / shape, n)
    return (g / g.mean()).tolist()
