"""The packed segment forward (port of ``make_packed_fn`` from
``repro/serving/speculative.py``; the draft runner and verification wait for
the speculative-decoding slice)."""

from __future__ import annotations

import torch

from repro_torch.serving.paged_cache import attach_tables, detach_tables

__all__ = ["make_packed_fn"]


def make_packed_fn(model):
    """The packed step: every argument has a fixed shape per engine.

      slot_ids  (G,)    scheduler slot of each segment row
      positions (G, S)  absolute token positions (-1 = padded cell)
      ctx       (G,)    write/attend horizon per row (last valid pos + 1)
      tokens    (G, S)  token ids (anything in padded cells)

    Row ``g`` writes its valid tokens' KV into ``slot_ids[g]``'s blocks and
    attends causally through that slot's block table. Returns
    (pools, logits (G, S, vocab))."""

    @torch.inference_mode()
    def packed_step(params, pools, bt, slot_ids, positions, ctx, tokens):
        caches = attach_tables(pools, bt, ctx, token_slots=slot_ids)
        out = model.apply(params, {"tokens": tokens}, positions=positions, caches=caches)
        return detach_tables(out.caches), out.logits[..., : model.cfg.vocab_size]

    return packed_step
