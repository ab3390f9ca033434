"""Serving engine (port of ``repro/serving/engine.py``).

``ServingEngine(model, params, sc)`` serves on the device that holds
``params``, on one of two paths:

* the paged continuous-batching scheduler (``scheduler.py``), for every
  model with cache policies unless ``ServeConfig.paged`` is False: a block
  pool of float pages in ``cache_dtype`` or int4 K-Means pages with
  ``kv_quant``, one packed step per iteration, on the card one captured CUDA
  graph. ``ServeConfig.speculative`` adds greedy speculative decoding with a
  draft model (``draft=`` or ``speculative.draft_artifact``);
* the fixed-slot ring-buffer engine (``paged=False``): slot-sized batches of
  left-padded prompts, one eager prefill per batch (its shape changes with
  the prompt length, as JAX re-traces per shape), then one decode step per
  token against ring caches whose per-row ``pad_len`` masks the pad keys.
  On the card the decode step is one captured CUDA graph per batch size,
  JAX's ``jax.jit(make_serve_step(...))``: the ring caches are allocated
  once per engine at ``batch_slots`` rows and reset in place per batch, and
  the token and position live in static device buffers. Recurrent layers'
  state (Mamba, RG-LRU) is zeroed per batch and takes no ``pad_len``: a
  left-padded row's pad tokens enter its state, as in JAX (the fixed-slot
  engine is exact for them only on equal-length prompts). The vlm family
  (no cache policies) always serves here: prefill and decode step take
  zero ``image_embeds``, as JAX's engine feeds them, and the cross caches
  ride with the rings (sliced to the batch, never written: JAX's rule).

``graph`` (not a ``ServeConfig`` field: it changes how the steps run, not
what they compute): None runs them as CUDA graphs on the card and eagerly
on the CPU, False eagerly everywhere, True as graphs or raises. Sampling is
greedy at temperature 0; otherwise the scheduler seeds each request, and
the fixed-slot engine samples batch-wide, as the JAX fallback does. A
capture that fails raises; nothing falls back.

``ServeConfig.telemetry`` (``serving/telemetry.py``; ``"metrics"`` by
default, or ``"off"``, ``"trace"``, ``"quality"`` or a ``TelemetryConfig``)
gives every engine a telemetry object: ``stats`` is rebuilt from its
registry, ``snapshot()`` returns every metric with the engine-side latency
percentiles (TTFT, inter-token, queue wait, end to end),
``export_chrome_trace(path)`` writes a Perfetto trace and
``telemetry.expfmt()`` the Prometheus text. The fixed-slot engine counts
into the same registry (``serving_fallback_*``) and spans its prefills and
decode steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.quantspec import QuantSpec
from repro_torch.distributed.sharding import gather_dim
from repro_torch.serving.graph_step import GraphStep
from repro_torch.serving.paged_cache import zero_state_slot
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.speculative import SpeculativeConfig, load_draft
from repro_torch.serving.telemetry import make_telemetry

__all__ = ["ServeConfig", "make_prefill_step", "make_serve_step", "image_inputs",
           "ServingEngine"]

_FALLBACK_COUNTERS = ("prefills", "steps", "tokens", "prompt_tokens", "pad_tokens")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    cache_len: int = 4096  # max context per request (prompt + generated)
    cache_dtype: str = "bfloat16"
    kv_quant: bool = False
    temperature: float = 0.0  # 0 => greedy
    paged: bool = True  # False forces the fixed-slot ring-buffer engine
    block_size: int = 16
    n_blocks: int = 0  # 0 -> slots * ceil(cache_len / block_size)
    prefill_chunk: int = 32
    token_budget: int = 0  # 0 -> slots + prefill_chunk
    prefix_cache: bool = True
    seg_width: int = 1
    # greedy speculative decoding with a draft model; None = off
    speculative: SpeculativeConfig | None = None
    # "off", "metrics" (counters, gauges, histograms, step ring), "trace"
    # (adds request timelines and spans), "quality" (trace + numerics
    # probes and the shadow probe) or a TelemetryConfig
    telemetry: object = "metrics"

    @classmethod
    def from_spec(cls, spec: QuantSpec, **kw) -> "ServeConfig":
        """KV-cache treatment from the spec's kv policy."""
        kw.setdefault("kv_quant", spec.kv_bits is not None)
        kw.setdefault("cache_dtype", spec.kv_dtype)
        return cls(**kw)


def image_inputs(model, b: int, device) -> dict:
    """The stub frontend's input for the vlm family: zero ``image_embeds``
    (b, n_img_tokens, d_model) in the compute dtype, as JAX's engine feeds
    them (a broadcast zero: the cached forward never reads them); {} for
    other families."""
    cfg = model.cfg
    if cfg.family != "vlm":
        return {}
    zero = torch.zeros((), dtype=getattr(torch, cfg.compute_dtype), device=device)
    return {"image_embeds": zero.expand(b, cfg.n_img_tokens, cfg.d_model)}


def _no_grad(t: torch.Tensor):
    """``inference_mode``, or for a sharded step ``no_grad``: DTensor's views
    cannot be made of inference tensors."""
    return torch.no_grad() if isinstance(t, DTensor) else torch.inference_mode()


def make_prefill_step(model, sc: ServeConfig) -> Callable:
    """prefill(params, caches, batch) -> (first token (B,) int32, caches,
    last-position logits (B, vocab_padded))."""

    def prefill(params, caches, batch: dict):
        tokens = batch["tokens"]
        with _no_grad(tokens):
            positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
            out = model.apply(params, batch, positions=positions, caches=caches,
                              last_only=True)
            logits = gather_dim(out.logits[:, -1], -1)
            return logits[:, : model.cfg.vocab_size].argmax(dim=-1).int(), out.caches, logits

    return prefill


def make_serve_step(model, sc: ServeConfig) -> Callable:
    """serve_step(params, caches, tokens (B, 1), pos ()) -> (next (B,) int32,
    caches, logits (B, vocab)): one token in against ring caches, written in
    place; ``logits`` are this step's, so sampling draws from the current
    distribution. ``pos`` is a device tensor: the step reads nothing on the
    host, so it can be captured as a CUDA graph."""

    def serve_step(params, caches, tokens, pos):
        with _no_grad(tokens):
            batch = {"tokens": tokens, **image_inputs(model, tokens.shape[0], tokens.device)}
            out = model.apply(params, batch, positions=pos.reshape(1), caches=caches)
            logits = gather_dim(out.logits[:, -1], -1)[:, : model.cfg.vocab_size]
            return logits.argmax(dim=-1).int(), out.caches, logits

    return serve_step


def _attach_pad_lens(caches: list[dict], pad_lens: torch.Tensor) -> list[dict]:
    """Every ring cache dict (recognised by ``slot_pos``) with the per-row
    ``pad_len`` (B,) that masks a left-padded prompt's pad keys; recurrent
    state dicts pass through."""
    return [c | {"pad_len": pad_lens} if "slot_pos" in c else c for c in caches]


class ServingEngine:
    """Batched generation over ``batch_slots`` request slots (see the module
    docstring for the two paths and ``graph``)."""

    def __init__(self, model, params, sc: ServeConfig, batch_slots: int = 8, draft=None,
                 graph: bool | None = None, calib_stats=None, shadow_params=None):
        """``draft`` (speculative configs): ``(model, params)``, ``(model,
        params, spec)`` or a ``load_quantized`` artifact; when omitted,
        ``sc.speculative.draft_artifact`` is loaded onto the params' device.

        ``calib_stats`` / ``shadow_params`` serve the ``quality`` level (see
        ``Scheduler``): per-tap calibration statistics
        (``core.artifact.load_calib_stats``) for drift scores, and the shadow
        probe's reference parameters (None: the serving parameters)."""
        self.model, self.params, self.sc, self.slots = model, params, sc, batch_slots
        self.device = next(params.parameters()).device
        self.telemetry = make_telemetry(sc.telemetry)
        policies = model.cache_policies()
        self.paged = sc.paged and policies is not None
        if self.paged and sc.speculative is not None and sc.seg_width < sc.speculative.k + 1 \
                and any(p.kind == "recurrent" for p in policies):
            # a recurrent verify segment (k + 1 cells) must fit in one row
            sc = dataclasses.replace(sc, seg_width=sc.speculative.k + 1)
            self.sc = sc
        if self.paged:
            if sc.speculative is not None and draft is None:
                if sc.speculative.draft_artifact is None:
                    raise ValueError("ServeConfig.speculative needs a draft model: set "
                                     "speculative.draft_artifact or pass draft=(model, "
                                     "params[, spec]) to the engine")
                draft = load_draft(sc.speculative.draft_artifact, device=self.device)
            self.scheduler = Scheduler(model, params, sc, slots=batch_slots, draft=draft,
                                       graph=graph, telemetry=self.telemetry,
                                       calib_stats=calib_stats, shadow_params=shadow_params)
            return
        if sc.speculative is not None:
            raise ValueError("speculative decoding needs the paged scheduler (paged=True "
                             "and a paged-capable model family)")
        if graph is None:
            graph = self.device.type == "cuda"
        elif graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph step needs the card; params are on {self.device}")
        self.scheduler = None
        self._graph_on = graph
        self._prefill = make_prefill_step(model, sc)
        self._step = make_serve_step(model, sc)
        self._fc = {k: self.telemetry.counter(f"serving_fallback_{k}")
                    for k in _FALLBACK_COUNTERS}
        self._ring: list[dict] | None = None  # batch_slots rows, made on first use
        self._pad_len = torch.zeros((batch_slots,), dtype=torch.int32, device=self.device)
        # per batch size: (token buffer (b, 1), position buffer (), graph or None)
        self._decode: dict[int, tuple[torch.Tensor, torch.Tensor, GraphStep | None]] = {}

    @property
    def stats(self) -> dict:
        """The scheduler's counters (paged path; under speculation also the
        draft's dispatches and the acceptance rate, accepted / drafted), or
        the fixed-slot engine's batch counters: prefills, decode steps,
        tokens served, prompt and pad cells and their ratio, and the seconds
        its decode graphs took to capture."""
        if self.scheduler is None:
            d = {k: c.value for k, c in self._fc.items()}
            d["pad_fraction"] = d["pad_tokens"] / max(1, d["prompt_tokens"])
            caps = [g.capture_s for _, _, g in self._decode.values()
                    if g is not None and g.capture_s is not None]
            d["graph_capture_s"] = sum(caps) if caps else None
            return d
        d = dict(self.scheduler.stats,
                 prefix_evictions=self.scheduler.allocator.evictions,
                 prefix_blocks_cached=self.scheduler.allocator.n_cached)
        if self.scheduler.draft is not None:
            d["draft_steps"] = self.scheduler.draft.steps
            d["acceptance_rate"] = d["accepted_tokens"] / max(1, d["drafted_tokens"])
        return d

    def snapshot(self) -> dict:
        """A JSON-able dump of every telemetry metric (``Telemetry.snapshot``)."""
        return self.telemetry.snapshot()

    def export_chrome_trace(self, path):
        """Write a Chrome / Perfetto trace-event JSON file (open it at
        ui.perfetto.dev); richest under ``telemetry="trace"``."""
        return self.telemetry.export_chrome_trace(path)

    def generate(self, prompts: list[list[int]], max_new_tokens: int | list[int] = 32,
                 eos_id: int | None = None, seed: int = 0) -> list[list[int]]:
        """Per-prompt lists of exactly ``max_new_tokens`` tokens (eos-padded).
        Per-request budgets need the paged scheduler. With a temperature, the
        scheduler samples prompt i from ``seed`` and salt i; the fixed-slot
        engine samples each batch from ``seed``."""
        budgets = (max_new_tokens if isinstance(max_new_tokens, list)
                   else [max_new_tokens] * len(prompts))
        if len(budgets) != len(prompts):
            raise ValueError("per-request max_new_tokens must match prompts")
        if self.paged:
            rids = [self.scheduler.submit(p, n, eos_id, seed, salt=i)
                    for i, (p, n) in enumerate(zip(prompts, budgets))]
            results = self.scheduler.run()
            return [results[r] for r in rids]
        if isinstance(max_new_tokens, list):
            raise ValueError("per-request budgets need the paged scheduler")
        out: list[list[int]] = []
        for i in range(0, len(prompts), self.slots):  # iterative, not recursive
            out += self._generate_batch(prompts[i : i + self.slots], max_new_tokens, eos_id,
                                        seed)
        return out

    # ------------------------------------------------------ fixed-slot engine
    def _ring_caches(self, pads: list[int]) -> list[dict]:
        """The engine's ring caches for a batch of ``len(pads)`` rows: views
        of the first rows, every slot emptied, recurrent state zeroed and
        ``pad_len`` set, in place (a captured decode step holds their
        addresses). Slots a batch left behind are masked by ``slot_pos``
        until overwritten. A vlm's cross caches come sliced to the batch,
        with no ``pad_len`` (they hold no positions)."""
        sc, b = self.sc, len(pads)
        if self._ring is None:
            self._ring = self.model.init_caches(self.slots, sc.cache_len, sc.cache_dtype,
                                                quantized=sc.kv_quant, layout="ring",
                                                device=self.device)
        for layer in self._ring:
            if "slot_pos" in layer:
                layer["slot_pos"].fill_(-1)
        zero_state_slot(self._ring, slice(None))
        self._pad_len[:b].copy_(torch.tensor(pads, dtype=torch.int32))
        shared = ("slot_pos", "kv_codebook", "state_codebook")
        rows = [{k: v if k in shared else v[:b] for k, v in layer.items()}
                for layer in self._ring]
        return _attach_pad_lens(rows, self._pad_len[:b])

    def _graph_fn(self, params, caches, tokens, pos):
        nxt, caches, logits = self._step(params, caches, tokens, pos)
        return caches, (nxt, logits)

    def _decode_step(self, caches: list[dict], tok: torch.Tensor, pos: int):
        """One decode step of the batch: the token and position go into the
        batch size's static buffers, then the graph replays (captured on the
        first call, warmed up on these same inputs, whose writes the first
        replay repeats) or the step runs eagerly. Returns (next, logits);
        a graph's are its static outputs, valid until the next replay."""
        b = tok.shape[0]
        if b not in self._decode:
            bufs = (torch.empty((b, 1), dtype=torch.int32, device=self.device),
                    torch.empty((), dtype=torch.int32, device=self.device))
            self._decode[b] = (*bufs, None)
        tok_buf, pos_buf, graph = self._decode[b]
        tok_buf.copy_(tok[:, None])
        pos_buf.fill_(pos)
        if not self._graph_on:
            with self.telemetry.annotate("fallback_step"):
                nxt, _, logits = self._step(self.params, caches, tok_buf, pos_buf)
            return nxt, logits
        if graph is None:
            graph = GraphStep(self._graph_fn, self.params, caches, (tok_buf, pos_buf),
                              (tok_buf.clone(), pos_buf.clone()))
            self._decode[b] = (tok_buf, pos_buf, graph)
        graph.capture(caches)  # outside the span: it wraps the replay
        with self.telemetry.annotate("fallback_step"):
            return graph(caches)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """``argmax(logits / T + g)``, g standard Gumbel noise (B, vocab) from
        the batch's generator, drawn as ``jax.random.gumbel`` draws it: the
        JAX fallback's ``categorical`` rule, batch-wide (not its noise)."""
        tiny = torch.finfo(torch.float32).tiny
        u = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
        u.uniform_(tiny, 1.0, generator=gen)
        return (logits / self.sc.temperature - torch.log(-torch.log(u))).argmax(dim=-1).int()

    def _generate_batch(self, prompts: list[list[int]], max_new_tokens: int,
                        eos_id: int | None, seed: int) -> list[list[int]]:
        """Left-pad the batch so every prompt ends at the same position,
        prefill it, then decode one token per step. With a temperature every
        token of the batch is drawn from one generator seeded ``seed`` (one
        per batch, as JAX keys each batch with ``PRNGKey(seed)``)."""
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        pads = [plen - len(p) for p in prompts]
        toks = torch.tensor([[0] * n + list(p) for n, p in zip(pads, prompts)],
                            dtype=torch.int32).to(self.device)
        caches = self._ring_caches(pads)
        self._fc["prefills"].add()
        self._fc["prompt_tokens"].add(b * plen)
        self._fc["pad_tokens"].add(sum(pads))
        with self.telemetry.annotate("fallback_prefill"):
            tok, caches, logits = self._prefill(
                self.params, caches, {"tokens": toks, **image_inputs(self.model, b, self.device)})
        vocab = self.model.cfg.vocab_size
        gen = None
        if self.sc.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            tok = self._sample(logits[:, :vocab], gen)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        outs = [tok]
        for pos in range(plen, plen + max_new_tokens - 1):
            tok, logits = self._decode_step(caches, tok, pos)
            self._fc["steps"].add()
            tok = self._sample(logits, gen) if gen is not None else tok.clone()
            if eos_id is not None:
                done = done | (tok == eos_id)
                tok = torch.where(done, eos_id, tok)
            outs.append(tok)
            if eos_id is not None and bool(done.all()):
                break
        self._fc["tokens"].add(b * len(outs))
        rows = torch.stack(outs, dim=1).tolist()
        pad = eos_id if eos_id is not None else 0
        return [row + [pad] * (max_new_tokens - len(row)) for row in rows]
