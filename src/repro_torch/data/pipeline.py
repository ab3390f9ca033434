"""Token data pipeline (port of ``repro/data/pipeline.py``): deterministic,
host-sharded, checkpoint-resumable.

Two sources:

* :class:`ByteCorpus` -- byte-level tokens of real text (by default the
  repository's own ``.py`` and ``.md`` files, the same root the JAX package
  reads, so both give one token array). Vocab 256.
* :func:`synthetic_corpus` -- a seeded order-2 Markov token stream for any
  vocab size.

Batch ``i`` of a pipeline built with the same (config, seed) is the same
across runs and restarts: the generator is counter-based (seeded by the
step), and :meth:`TokenPipeline.state` / :meth:`TokenPipeline.restore`
round-trip through the checkpointer. Batches stay numpy int32, as JAX's do;
the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pathlib

import numpy as np

__all__ = ["DataConfig", "ByteCorpus", "TokenPipeline", "synthetic_corpus"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    process_index: int = 0
    process_count: int = 1


class ByteCorpus:
    """Byte-level corpus from text files (default: this repository's sources)."""

    vocab_size = 256

    def __init__(self, root: str | None = None, suffixes=(".py", ".md")):
        root_p = pathlib.Path(root) if root else pathlib.Path(__file__).resolve().parents[3]
        parts = []
        for f in sorted(root_p.rglob("*")):
            if f.suffix in suffixes and f.is_file():
                try:
                    parts.append(f.read_bytes())
                except OSError:
                    continue
        blob = b"\n".join(parts)
        if len(blob) < 1 << 16:
            blob = blob * ((1 << 16) // max(len(blob), 1) + 1)
        self.tokens = np.frombuffer(blob, dtype=np.uint8).astype(np.int32)

    def fingerprint(self) -> str:
        return hashlib.sha256(self.tokens.tobytes()).hexdigest()[:16]


def synthetic_corpus(vocab: int, length: int, seed: int = 0) -> np.ndarray:
    """Seeded order-2 Markov stream: each context prefers ~4 successors."""
    rng = np.random.default_rng(seed)
    n_ctx = 4096
    succ = rng.integers(0, vocab, size=(n_ctx, 4))
    out = np.empty(length, dtype=np.int32)
    a = b = 0
    u = rng.integers(0, 4, size=length)
    greedy = rng.random(length) < 0.9
    for i in range(length):
        ctx = (a * 31 + b) % n_ctx
        out[i] = succ[ctx, u[i]] if greedy[i] else rng.integers(0, vocab)
        a, b = b, out[i]
    return out


class TokenPipeline:
    """Random-crop LM batches over a token array, stateful and resumable."""

    def __init__(self, tokens: np.ndarray, cfg: DataConfig):
        if cfg.global_batch % cfg.process_count:
            raise ValueError("global_batch must divide by process_count")
        self.tokens = tokens
        self.cfg = cfg
        self._step = 0

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.process_count

    def _rng_for(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed, step))  # the state is the step

    def next_batch(self) -> dict:
        """{"tokens": (local_batch, seq_len + 1) int32}: inputs and targets."""
        cfg = self.cfg
        rng = self._rng_for(self._step)
        span = cfg.seq_len + 1
        starts = rng.integers(0, len(self.tokens) - span, size=cfg.global_batch)
        lo = cfg.process_index * self.local_batch
        sel = starts[lo : lo + self.local_batch]
        batch = np.stack([self.tokens[s : s + span] for s in sel]).astype(np.int32)
        self._step += 1
        return {"tokens": batch}

    def state(self) -> dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError("restoring pipeline with mismatched seed")
        self._step = int(state["step"])
