"""One shared prefix, then a distinct prompt: ``prefix_tokens`` tokens
drawn once from the run's seed go before every request's ``n`` distinct
tokens (vLLM's ``benchmark_serving.py --random-prefix-len``: the prefix
comes on top of the drawn length)."""

import numpy as np

from kbench.prompts import distinct


def tokens(spec: dict, seed: int, i: int, n: int, vocab: int) -> list[int]:
    prefix = np.random.default_rng([seed, 0, 1]).integers(0, vocab, size=spec["prefix_tokens"])
    return prefix.tolist() + distinct.tokens(spec, seed, i, n, vocab)
