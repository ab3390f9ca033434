"""Serving engine on the paged continuous-batching path
(port of ``repro/serving/engine.py``).

``ServingEngine(model, params, sc)`` serves on the device that holds
``params``; the scheduler owns the block pool -- float pages in
``cache_dtype``, or int4 K-Means pages with ``kv_quant`` -- and runs one
packed step per iteration, on the card as one captured CUDA graph
(``graph=False`` runs it eagerly). Sampling is greedy at temperature 0,
else seeded per request as in JAX. The fixed-slot ring-buffer fallback,
speculation and telemetry are not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.quantspec import QuantSpec
from repro_torch.serving.scheduler import Scheduler

__all__ = ["ServeConfig", "ServingEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    cache_len: int = 4096  # max context per request (prompt + generated)
    cache_dtype: str = "bfloat16"
    kv_quant: bool = False
    temperature: float = 0.0  # 0 => greedy
    block_size: int = 16
    n_blocks: int = 0  # 0 -> slots * ceil(cache_len / block_size)
    prefill_chunk: int = 32
    token_budget: int = 0  # 0 -> slots + prefill_chunk
    prefix_cache: bool = True
    seg_width: int = 1

    @classmethod
    def from_spec(cls, spec: QuantSpec, **kw) -> "ServeConfig":
        """KV-cache treatment from the spec's kv policy."""
        kw.setdefault("kv_quant", spec.kv_bits is not None)
        kw.setdefault("cache_dtype", spec.kv_dtype)
        return cls(**kw)


class ServingEngine:
    """Batched generation over ``batch_slots`` request slots.

    ``graph`` (not a ``ServeConfig`` field: it changes how the step runs, not
    what it computes): None runs the packed step as a CUDA graph on the card
    and eagerly on the CPU, False eagerly everywhere, True as a graph or
    raises (see :class:`Scheduler`)."""

    def __init__(self, model, params, sc: ServeConfig, batch_slots: int = 8,
                 graph: bool | None = None):
        self.model, self.params, self.sc, self.slots = model, params, sc, batch_slots
        self.scheduler = Scheduler(model, params, sc, slots=batch_slots, graph=graph)

    @property
    def stats(self) -> dict:
        return dict(self.scheduler.stats,
                    prefix_evictions=self.scheduler.allocator.evictions,
                    prefix_blocks_cached=self.scheduler.allocator.n_cached)

    def generate(self, prompts: list[list[int]], max_new_tokens: int | list[int] = 32,
                 eos_id: int | None = None, seed: int = 0) -> list[list[int]]:
        """Per-prompt lists of exactly ``max_new_tokens`` tokens (eos-padded).
        With a temperature, prompt i samples from ``seed`` and salt i."""
        budgets = (max_new_tokens if isinstance(max_new_tokens, list)
                   else [max_new_tokens] * len(prompts))
        if len(budgets) != len(prompts):
            raise ValueError("per-request max_new_tokens must match prompts")
        rids = [self.scheduler.submit(p, n, eos_id, seed, salt=i)
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        results = self.scheduler.run()
        return [results[r] for r in rids]
