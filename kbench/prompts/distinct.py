"""Distinct prompts: ``n`` tokens uniform over the vocabulary, drawn from
the run's seed and the request's index, so no two requests share a
prefix and the prefix cache finds nothing."""

import numpy as np


def tokens(spec: dict, seed: int, i: int, n: int, vocab: int) -> list[int]:
    return np.random.default_rng([seed, i]).integers(0, vocab, size=n).tolist()
