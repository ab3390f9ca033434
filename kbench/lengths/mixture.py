"""A mixture of length laws: ``parts``, each a length law's spec with a
``weight``; part k gives its share of the ``n`` lengths (the last part
the rest)."""


def draw(spec: dict, n: int, rng) -> list[int]:
    from kbench import traffic

    parts = spec["parts"]
    total = sum(p["weight"] for p in parts)
    out: list[int] = []
    for k, p in enumerate(parts):
        m = n - len(out) if k == len(parts) - 1 else round(n * p["weight"] / total)
        out += traffic.lengths(p, m, rng)
    return out
