"""Uniform lengths: the ``(i + 0.5) / n`` quantiles of ``[min, max]``,
rounded."""


def draw(spec: dict, n: int, rng) -> list[int]:
    return [int(round(spec["min"] + (spec["max"] - spec["min"]) * (i + 0.5) / n))
            for i in range(n)]
