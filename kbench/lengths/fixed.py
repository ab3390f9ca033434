"""Every request the same length: ``tokens`` (vLLM's
``benchmark_serving.py --dataset-name random`` at its default
``--random-range-ratio``)."""


def draw(spec: dict, n: int, rng) -> list[int]:
    return [int(spec["tokens"])] * n
