"""The one traffic generator: it reads a mix's parameters from
``traffic/<name>.json`` and draws requests from a seed.

A mix names three laws, each a module found by its name:

* ``arrivals``: ``arrivals/<law>.py``. An open law (``OPEN = True``, such
  as ``poisson`` or ``gamma``) gives the gaps between arrivals at a mean
  of one; the harness divides them by the cell's ``rate_per_s`` and sends
  each request when it falls due, whatever the system does. A closed law
  (``backlog``) gives the number of waiting requests the harness tops the
  queue up to before every step;
* ``prompt`` and ``output``: ``lengths/<law>.py`` (``fixed``,
  ``lognormal``, ``uniform``, ``mixture``), the prompt's and the
  output's length in tokens;
* ``tokens`` (default ``distinct``): ``prompts/<law>.py``, the prompt's
  tokens from the run's seed and the request's index (``shared_prefix``
  puts one prefix before every prompt).

and ``ramp_s``, the seconds of traffic sent before the window, and
``schedule_seed``. An unknown law is an error.

Every run of a mix sends the same schedule: ``POOL`` lengths of each kind
and ``ARRIVALS`` gaps, drawn and put in an order once from the mix's
``schedule_seed``, whatever the run's seed, window or rate. The run's seed
draws the prompt tokens. A shuffle per run seed moved a chat cell's p90
time to first token by 28 % from seed to seed on an H100, where two runs of
one seed agreed within 5 %: the order of a Poisson schedule sets its tail.
"""

from __future__ import annotations

import importlib
import json
import pathlib

import numpy as np

__all__ = ["load", "law", "lengths", "Plan", "plan"]

HERE = pathlib.Path(__file__).resolve().parent
POOL = 1024  # lengths of each kind; request i takes entry i mod POOL
ARRIVALS = 8192  # gaps of an open law, far more than any window sends
KINDS = ("arrivals", "lengths", "prompts")


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def law(kind: str, spec: dict):
    """The module of ``spec["law"]`` under ``kbench/<kind>/``."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind of law {kind!r}")
    name = spec["law"]
    if not (HERE / kind / f"{name}.py").is_file():
        raise ValueError(f"unknown {kind} law {name!r}")
    return importlib.import_module(f"kbench.{kind}.{name}")


def lengths(spec: dict, n: int, rng: np.random.Generator) -> list[int]:
    """``n`` lengths of a length law (in the law's order)."""
    return [int(v) for v in law("lengths", spec).draw(spec, n, rng)]


class Plan:
    """A run's requests: lengths, prompt tokens (from the run's seed) and,
    for an open law, the due times (seconds from the start of the
    traffic); for a closed one the queue to keep (``target``)."""

    def __init__(self, mix: dict, seed: int, vocab: int, rate: float | None = None):
        self.mix, self.vocab = mix, vocab
        self.seed = int(seed) % 2**63
        self.arrivals = law("arrivals", mix["arrivals"])
        self.open = bool(self.arrivals.OPEN)
        self.token_spec = mix.get("tokens", {"law": "distinct"})
        self.tokens = law("prompts", self.token_spec)
        rng = np.random.default_rng(mix["schedule_seed"])
        self.prompt_lens = rng.permutation(lengths(mix["prompt"], POOL, rng)).tolist()
        self.output_lens = rng.permutation(lengths(mix["output"], POOL, rng)).tolist()
        self.due: list[float] = []
        if self.open:
            if not rate or rate <= 0:
                raise ValueError("an open law needs the cell's rate_per_s")
            gaps = np.asarray(self.arrivals.gaps(mix["arrivals"], ARRIVALS, rng), dtype=float)
            self.due = (np.cumsum(rng.permutation(gaps)) / rate).tolist()

    def target(self, slots: int) -> int:
        """Waiting requests a closed law keeps in the queue."""
        return int(self.arrivals.target(self.mix["arrivals"], slots))

    def request(self, i: int) -> tuple[list[int], int]:
        """Request i: (prompt tokens, max new tokens)."""
        n = self.prompt_lens[i % POOL]
        toks = self.tokens.tokens(self.token_spec, self.seed, i, n, self.vocab)
        return toks, self.output_lens[i % POOL]


def plan(mix: dict, seed: int, vocab: int, rate: float | None = None) -> Plan:
    return Plan(mix, seed, vocab, rate)
