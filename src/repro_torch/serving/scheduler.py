"""Continuous-batching scheduler over the paged KV pool
(port of ``repro/serving/scheduler.py``).

Request lifecycle::

    QUEUED --admit (FCFS, free-block budget)--> RUNNING (prefilling)
    RUNNING --prompt fully written--> RUNNING (decoding)
    RUNNING --EOS / max-tokens--> FINISHED      (slot + blocks freed)
    RUNNING --pool exhausted--> PREEMPTED        (requeued at the front,
                                                  recomputed on re-admission)

Each iteration runs ONE packed step over a fixed ``rows x seg_width`` grid
of token cells: decoding requests get their row first (admission can never
starve decode), prefill segments fill the remaining rows FCFS. Admission
reserves the blocks of the whole context plus the first decode token.
With ``prefix_cache`` on, full prompt blocks are registered under their
chain hash; an admission aliases the longest cached prefix and skips its
prefill, and a write into a shared block first copies it (copy-on-write).

On CUDA the packed step is one captured CUDA graph (``graph_step.py``), as
JAX runs it as one jitted program: the host assembles the step's five
inputs in pinned arrays, copies them into the graph's static device
buffers and replays it. ``graph=False`` runs the same step eagerly, as
``jax.disable_jit()`` would; the CPU always runs it eagerly.

Sampling runs on the step's logits outside the step, as in JAX: greedy
(``temperature == 0``) is one argmax over the whole step; otherwise each
request draws Gumbel noise from its own generator, seeded from
``(seed, salt or rid)``, so its tokens do not depend on how steps were
packed.

Speculative decoding (``ServeConfig.speculative``, greedy only): after the
step's plan is stable, a :class:`~repro_torch.serving.speculative.DraftRunner`
drafts ``k`` tokens per decoding request; each decoder's verify segment
``[next_token, d_1 .. d_k]`` takes ``ceil((k + 1) / seg_width)`` rows of the
same packed step (verify segments first, then prefill), every verify argmax
comes to the host in one copy, ``greedy_verify`` commits 1 to ``k + 1``
tokens, blocks that hold only rejected drafts are freed
(``BlockAllocator.truncate``) and the draft rewinds.

Telemetry (``ServeConfig.telemetry``, ``serving/telemetry.py``): the serving
counters are registry counters under JAX's ``serving_*`` names, ``stats``
is rebuilt from them, and each request's lifecycle and each step's record
go to the same object. None of it reads the device: cells are counted on
the host's position array. Each step record lists ``step``'s host phases
(``admit``, ``plan``, ``pack``, ``replay``, ``sample``, ``commit``) on the
profiler's clock; under ``fence`` on the card the packed step is captured
with a marker kernel at each region boundary the model code marks, and
each record of a replay carries the regions in marker order
(``region_marks``). At the ``quality`` level 1 in
``quality_sample_every`` steps (step 0 always) runs the probed step
(``speculative.make_probed_packed_fn``), on the card a second captured
graph; its probe dict comes to the host in one copy for
``core.numerics.QualityMonitor``. Every ``quality_shadow_every`` steps a
cache-free teacher-forced forward over the deepest decoder's committed
context (padded to ``cache_len``) gives the shadow probe's logit KL and
agreements, computed on the host in numpy.

Sliding-window models (the ``windowed_paged`` policy) keep logical block
tables: position p stays at ``table[p // block_size]``, and after every
step each request's blocks that lie wholly below ``prefilled - window + 1``
are freed and left as -1 holes (``_release_windowed``), so a request holds
at most ``ceil(window / block_size) + 1`` live blocks once its prompt is
written. The attention kernels and their plain versions clamp a hole to
block 0, and the window mask hides every key there. Prefix sharing is off
unless every layer is plain ``paged_kv``.

Recurrent layers (the ``recurrent`` policy: Mamba, RG-LRU) cost no blocks
and pin their slot's state, which is zeroed on admission. Their state is
gathered and stored once per row, so a slot gets at most one row per step:
its prefill chunk is capped at ``seg_width`` tokens, and a verify segment
must fit one row (the engine widens ``seg_width`` to ``k + 1``). The step
stores each row's state after its last cell; when verification accepts
fewer cells, the corrective commit copies the state after the last
consumed cell from the step's ``*_steps`` transients over the slot.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque

import numpy as np
import torch

from repro_torch.core import kernel_routing as kr
from repro_torch.serving.graph_step import GraphStep, StepInputs, packed_idle
from repro_torch.serving.paged_cache import (
    BlockAllocator,
    PagedCacheConfig,
    blocks_needed,
    chain_hash,
    copy_blocks,
    prefix_seed,
    release_horizon,
    zero_state_slot,
)
from repro_torch.serving.speculative import (DraftRunner, greedy_verify, make_packed_fn,
                                              make_probed_packed_fn, rejection_sample)
from repro_torch.serving.telemetry import linear_buckets, log_buckets, make_telemetry

__all__ = ["RequestState", "Request", "Scheduler"]

_COUNTERS = ("packed_steps", "decode_steps", "prefill_chunks", "mixed_steps",
             "decode_slot_tokens", "prefill_tokens", "packed_tokens", "prefix_hits",
             "prefix_hit_tokens", "prefill_skipped", "cow_copies", "preemptions",
             "spec_rounds", "drafted_tokens", "accepted_tokens", "rolled_back_tokens")


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64) - x.max()
    e = np.exp(x)
    return e / e.sum()


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None
    state: RequestState = RequestState.QUEUED
    context: list[int] = dataclasses.field(default_factory=list)
    generated: list[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0
    next_token: int | None = None
    blocks: list[int] = dataclasses.field(default_factory=list)
    block_hashes: list[bytes] = dataclasses.field(default_factory=list)
    slot: int = -1
    gen: torch.Generator | None = None  # sampling noise (temperature > 0)

    @property
    def decoding(self) -> bool:
        return self.prefilled >= len(self.context)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return self.eos_id is not None and bool(self.generated) and \
            self.generated[-1] == self.eos_id

    def output(self) -> list[int]:
        out = list(self.generated[: self.max_new_tokens])
        pad = self.eos_id if self.eos_id is not None else 0
        return out + [pad] * (self.max_new_tokens - len(out))


class Scheduler:
    """Owns the block pool, the allocator and the packed step.

    ``sc`` is a :class:`repro_torch.serving.engine.ServeConfig`: ``cache_len``
    bounds context per request, ``block_size`` / ``n_blocks`` size the pool
    (0 -> slots * blocks per request), ``token_budget`` sizes the grid
    (0 -> slots + prefill_chunk), ``seg_width`` packs that many tokens per
    segment row, ``prefix_cache`` turns on prefix sharing (only when every
    layer's policy is ``paged_kv``).

    ``graph``: None captures the packed step (and a draft's steps) as CUDA
    graphs on CUDA and runs them eagerly on the CPU; False runs them eagerly;
    True demands the graphs (and raises on the CPU).

    ``draft`` (speculative configs): ``(model, params)`` or ``(model,
    params, spec)``, e.g. a ``load_quantized`` artifact; the spec's KV policy
    sizes the draft pool.

    ``telemetry``: the engine's telemetry object (default: made from
    ``sc.telemetry``). At the ``quality`` level, ``calib_stats`` (per-tap
    calibration statistics, ``core.artifact.load_calib_stats``) are what
    live probes drift-score against (without them the first probed step is
    the baseline), and ``shadow_params`` are the shadow probe's reference
    parameters (None: the serving parameters, the self-reference whose
    agreement must be 1).
    """

    def __init__(self, model, params, sc, slots: int = 8, draft=None,
                 graph: bool | None = None, telemetry=None, calib_stats=None,
                 shadow_params=None):
        policies = model.cache_policies()
        # paged layers cost blocks; recurrent layers cost none but pin their
        # slot's state. Blocks wholly below prefilled - W + 1 are freed after
        # every step; 0 (never) whenever a full-attention layer needs every block
        self._has_paged = any(p.kind in ("paged_kv", "windowed_paged") for p in policies)
        self._rec = any(p.kind == "recurrent" for p in policies)
        self.release_window = release_horizon(policies)
        self.model, self.params, self.sc, self.slots = model, params, sc, slots
        self.device = next(params.parameters()).device
        if graph is None:
            graph = self.device.type == "cuda"
        elif graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph step needs the card; params are on {self.device}")
        self.telemetry = tel = (telemetry if telemetry is not None
                                else make_telemetry(getattr(sc, "telemetry", "metrics")))
        self.spec = sc.speculative
        self.draft: DraftRunner | None = None
        if self.spec is not None:
            if sc.temperature > 0:
                rejection_sample()  # greedy only: raises NotImplementedError
            if draft is None:
                raise ValueError("speculative serving needs a draft model: pass "
                                 "draft=(model, params[, spec]) or set "
                                 "speculative.draft_artifact on the engine")
            dm, dp, dspec = (tuple(draft) + (None,))[:3]
            if dm.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(f"draft vocab {dm.cfg.vocab_size} != target vocab "
                                 f"{model.cfg.vocab_size}: verification compares argmaxes")
            self.draft = DraftRunner(
                dm, dp, slots=slots, cache_len=sc.cache_len, k=self.spec.k,
                block_size=sc.block_size,
                cache_dtype=dspec.kv_dtype if dspec else sc.cache_dtype,
                kv_quant=(dspec.kv_bits is not None) if dspec else sc.kv_quant,
                token_budget=self.spec.draft_token_budget, graph=graph, telemetry=tel)
        # grid: rows x seg_width cells; every slot's decode or verify segment
        # (k + 1 cells under speculation) must fit at once
        self.seg_width = max(1, sc.seg_width)
        seg_len = self.spec.k + 1 if self.spec else 1
        self._dec_rows = -(-seg_len // self.seg_width)
        base = sc.token_budget or (slots + sc.prefill_chunk)
        rows = -(-base // self.seg_width)
        if sc.token_budget == 0:
            rows = max(rows, slots * self._dec_rows)
        if rows < slots * self._dec_rows:
            raise ValueError(f"token_budget {base} gives {rows} segment rows of width "
                             f"{self.seg_width} but decode reservation needs "
                             f"{slots * self._dec_rows} (slots x ceil((k+1)/seg_width))")
        if self._rec and self._dec_rows > 1:
            raise ValueError("recurrent layers gather and store state by slot, so a verify "
                             f"segment must fit in one grid row: raise seg_width to >= k+1 = "
                             f"{seg_len} (got {self.seg_width})")
        self.rows = rows
        self.token_budget = rows * self.seg_width
        max_blk = blocks_needed(sc.cache_len, sc.block_size)
        n_blocks = sc.n_blocks or slots * max_blk
        self.pcfg = PagedCacheConfig(block_size=sc.block_size, n_blocks=n_blocks,
                                     max_blocks_per_seq=max_blk)
        self.pools = model.init_caches(slots, sc.cache_len, sc.cache_dtype,
                                       quantized=sc.kv_quant, layout="paged",
                                       block_size=sc.block_size, n_blocks=n_blocks,
                                       device=self.device)
        # prefix sharing aliases blocks, which only composes with layers that
        # keep every block: a windowed layer would free a shared block
        prefix_on = sc.prefix_cache and all(p.kind == "paged_kv" for p in policies)
        self.allocator = BlockAllocator(n_blocks, prefix_cache=prefix_on, telemetry=tel)
        self._hash_seed = prefix_seed(
            family=model.cfg.family, n_layers=model.cfg.n_layers,
            n_kv_heads=model.cfg.n_kv_heads, head_dim=model.cfg.head_dim,
            kv_quant=sc.kv_quant, cache_dtype=str(sc.cache_dtype),
            block_size=sc.block_size)
        self._queue: deque[Request] = deque()
        self._running: list[Request] = []
        self._slot_free = list(range(slots - 1, -1, -1))
        self._next_rid = 0
        # the serving counters live in the telemetry registry (``stats``
        # rebuilds its dict from them); at level off they are no-ops
        self._c = {k: tel.counter(f"serving_{k}") for k in _COUNTERS}
        self._g_peak = tel.gauge("serving_pool_occupancy_peak", "high-water live-block fraction")
        tel.gauge("serving_queue_depth", fn=lambda: len(self._queue))
        tel.gauge("serving_running_requests", fn=lambda: len(self._running))
        # GEMM and detection routes (core/kernel_routing): lazy gauges over
        # the process-wide dispatch counts
        self._g_routes = {
            "lut_kernel_calls": tel.gauge("serving_lut_kernel_calls", fn=kr.kernel_calls,
                                          help="projections routed to the fused LUT-GEMM kernel"),
            "lut_jnp_calls": tel.gauge("serving_lut_jnp_calls", fn=kr.jnp_calls,
                                       help="projections routed to the plain LUT-GEMM"),
            "lut_fallbacks": tel.gauge("serving_lut_fallbacks", fn=kr.fallback_count,
                                       help="explicit kernel->plain GEMM demotions"),
            "outlier_detect_calls": tel.gauge(
                "serving_outlier_detect_calls", fn=kr.detect_calls,
                help="outlier-branch detection resolutions (any route)"),
            "outlier_kernel_calls": tel.gauge(
                "serving_outlier_kernel_calls", fn=kr.detect_kernel_calls,
                help="detections routed to the Orizuru kernels"),
            "outlier_jnp_calls": tel.gauge(
                "serving_outlier_jnp_calls", fn=kr.detect_jnp_calls,
                help="detections routed to the plain stable sort / threshold scoring"),
            "outlier_fallbacks": tel.gauge(
                "serving_outlier_fallbacks", fn=kr.detect_fallback_count,
                help="explicit detection kernel->plain demotions"),
            "outlier_comp_gather": tel.gauge(
                "serving_outlier_comp_gather",
                fn=lambda: kr.comp_route_counts().get("gather", 0),
                help="compensations resolved to the row-gather route"),
            "outlier_comp_scatter": tel.gauge(
                "serving_outlier_comp_scatter",
                fn=lambda: kr.comp_route_counts().get("scatter", 0),
                help="compensations resolved to the scatter + dense route"),
            "outlier_comp_kernel": tel.gauge(
                "serving_outlier_comp_kernel",
                fn=lambda: kr.comp_route_counts().get("kernel", 0),
                help="compensations resolved to the sparse compensation kernel"),
        }
        k1 = (self.spec.k + 1) if self.spec else 1
        self._h_accept = tel.histogram("serving_spec_accepted_per_round",
                                       linear_buckets(0.0, float(k1), k1),
                                       "accepted draft tokens per verify round")
        self._h_draft_round = tel.histogram("serving_draft_round_s", log_buckets(1e-6, 1e2),
                                            "draft propose (catch-up + scan) per round, seconds")
        self._c_draft_time = tel.counter("serving_draft_time_s",
                                         "total seconds in draft proposal")
        self._c_target_time = tel.counter("serving_target_time_s",
                                          "total seconds in target packed steps")
        self._g_live_peak = tel.gauge(
            "serving_peak_live_blocks_per_seq",
            help="high-water live (non-freed) blocks held by any one request")
        self._packed_fn = make_packed_fn(model, extras=True)
        self._in = StepInputs(((slots, max_blk), (rows,), (rows, self.seg_width), (rows,),
                               (rows, self.seg_width)), self.device)
        self.graph = (GraphStep(self._packed_fn, params, self.pools, self._in.dev,
                                packed_idle(self._in.dev), regions=tel.fence)
                      if graph else None)
        self.last_logits: torch.Tensor | None = None  # (rows, S, vocab) of the last step
        # ---- quality level: the numerics probes ------------------------------
        # every other level runs the packed step alone; quality runs the
        # probed step (a second graph on the card) on sampled steps
        self._quality = None
        self.probe_graph: GraphStep | None = None
        self._step_i = 0
        if tel.quality:
            from repro_torch.core import numerics as nx

            self._probed_fn = make_probed_packed_fn(model, extras=True)
            self._probe_layout: list[tuple[str, tuple[int, ...]]] = []
            if graph:
                self.probe_graph = GraphStep(self._probe_step, params, self.pools,
                                             self._in.dev, packed_idle(self._in.dev))
            self._quality = nx.QualityMonitor(tel, calib_stats=calib_stats,
                                              drift_threshold=tel.cfg.quality_drift_threshold)
            self._shadow_params = shadow_params if shadow_params is not None else params
            self._shadow_len = sc.cache_len
            self._h_shadow_kl = tel.histogram(
                "numerics_shadow_logit_kl", log_buckets(1e-9, 1e3),
                "KL(serving || shadow reference) at the probed decode position, nats")
            self._g_shadow_top1 = tel.gauge(
                "numerics_shadow_top1_agreement",
                "serving vs shadow argmax agreement at the probed position")
            self._g_shadow_agree = tel.gauge(
                "numerics_shadow_token_agreement",
                "teacher-forced shadow greedy agreement over the committed decode window")
            self._c_shadow = tel.counter("numerics_shadow_probes",
                                         "shadow-reference forwards run")
            if self.spec is not None:
                self._h_first_reject = tel.histogram(
                    "numerics_spec_first_reject_pos",
                    linear_buckets(0.0, float(self.spec.k + 1), self.spec.k + 1),
                    "draft position of the first greedy rejection")

    @property
    def stats(self) -> dict:
        """The serving counters, rebuilt from the telemetry registry (all
        zeros under ``telemetry="off"``), with the seconds the graphs took to
        capture (None before a capture, and without graphs)."""
        d = {k: c.value for k, c in self._c.items()}
        d["peak_occupancy"] = self._g_peak.value
        d["peak_live_blocks_per_seq"] = self._g_live_peak.value
        for k, g in self._g_routes.items():
            d[k] = g.value
        d["graph_capture_s"] = None if self.graph is None else self.graph.capture_s
        if self.probe_graph is not None:
            d["probe_capture_s"] = self.probe_graph.capture_s
        if self.draft is not None:
            d["draft_capture_s"] = self.draft.capture_s
        return d

    def _count(self, key: str, n: int = 1) -> None:
        self._c[key].add(n)

    def _note_occupancy(self) -> None:
        self._g_peak.set_max(self.allocator.occupancy)

    # ----------------------------------------------------------------- host
    def submit(self, prompt: list[int], max_new_tokens: int, eos_id: int | None = None,
               seed: int = 0, salt: int | None = None) -> int:
        """Queue a request. With ``temperature > 0`` its noise comes from a
        generator seeded ``seed * 100_003 + (salt or rid)``, JAX's key: the
        engine passes each prompt's index as ``salt``, so a (seed, prompt
        list) samples alike across ``generate`` calls."""
        if not prompt:
            raise ValueError("empty prompt (nothing to prefill)")
        if len(prompt) + max_new_tokens > self.pcfg.max_context:
            raise ValueError(f"prompt({len(prompt)}) + max_new({max_new_tokens}) exceeds "
                             f"cache_len {self.pcfg.max_context}")
        rid = self._next_rid
        self._next_rid += 1
        gen = None
        if self.sc.temperature > 0:
            key = seed * 100_003 + (rid if salt is None else salt)
            gen = torch.Generator(device=self.device).manual_seed(key)
        self._queue.append(Request(rid=rid, prompt=list(prompt), max_new_tokens=max_new_tokens,
                                   eos_id=eos_id, context=list(prompt), gen=gen))
        self.telemetry.request_submitted(rid, len(prompt))
        return rid

    def run(self) -> dict[int, list[int]]:
        """Drain queue and running set; returns {rid: generated tokens}."""
        results: dict[int, list[int]] = {}
        while self.step(results):
            pass
        return results

    def step(self, results: dict[int, list[int]]) -> bool:
        """Refill slots, retire finished requests, run one packed step.
        Returns True while work remains."""
        t_admit = self.telemetry.stamp()
        admitted = self._refill_slots()
        for r in [r for r in self._running if r.done]:
            self._finish(r, results)
        if self._running:
            self._packed_once(results, [("admit", t_admit, self.telemetry.stamp())])
            return True
        if self._queue and not admitted:
            r = self._queue[0]
            need = self._blocks_for(len(r.context) + 1)
            raise RuntimeError(
                f"request {r.rid} needs {need} blocks (context + first decode); "
                f"pool has {self.allocator.n_free}/{self.pcfg.n_blocks} free")
        return bool(self._queue)

    # ------------------------------------------------------------- admission
    def _refill_slots(self) -> int:
        """FCFS admission reserving ``blocks_needed(len + 1)``; the longest
        cached prefix is aliased and its prefill skipped (at least one prompt
        token is always computed: its logits seed sampling)."""
        admitted = 0
        bs = self.pcfg.block_size
        while self._queue and self._slot_free:
            r = self._queue[0]
            need = self._blocks_for(len(r.context) + 1)
            shared, hashes = self._match_prefix(r)
            fresh = self.allocator.alloc(need - len(shared))
            if fresh is None:
                if shared:
                    self.allocator.free(list(reversed(shared)))
                break
            self._queue.popleft()
            r.blocks, r.block_hashes = shared + fresh, hashes
            r.slot, r.state = self._slot_free.pop(), RequestState.RUNNING
            r.prefilled = min(len(shared) * bs, len(r.context) - 1)
            if self._rec:  # a slot's state is reused in place: it must not leak
                zero_state_slot(self.pools, r.slot)
            if self.draft is not None:
                self.draft.reset(r.slot)
            if shared:
                self._count("prefix_hits")
                self._count("prefix_hit_tokens", len(shared) * bs)
                self._count("prefill_skipped", r.prefilled)
            self.telemetry.request_admitted(r.rid, prefix_hit_tokens=len(shared) * bs)
            self._running.append(r)
            admitted += 1
        self._note_occupancy()
        return admitted

    def _match_prefix(self, r: Request) -> tuple[list[int], list[bytes]]:
        if not self.allocator.prefix_cache:
            return [], []
        bs = self.pcfg.block_size
        ids: list[int] = []
        hashes: list[bytes] = []
        h = self._hash_seed
        for j in range(len(r.context) // bs):
            h = chain_hash(h, r.context[j * bs : (j + 1) * bs])
            bid = self.allocator.lookup(h)
            if bid is None:
                break
            self.allocator.incref(bid)
            ids.append(bid)
            hashes.append(h)
        return ids, hashes

    # ------------------------------------------------------------ packed step
    def _k_for(self, r: Request) -> int:
        """Drafts to propose for ``r`` this round: ``k``, clipped so that
        verification never commits past the request's budget (which also
        keeps every write below ``cache_len``)."""
        if self.spec is None:
            return 0
        return max(0, min(self.spec.k, r.max_new_tokens - len(r.generated) - 1))

    def _packed_once(self, results: dict, phases: list) -> None:
        """Assemble and run one grid: decode or verify segments first, then
        prefill segments FCFS over the remaining rows. ``phases`` holds the
        step's host phases so far; each phase after it is appended."""
        S = self.seg_width
        tel = self.telemetry
        t_host0 = tel.now()
        p0 = tel.stamp()
        blocks_alloc0 = self.allocator.blocks_allocated
        blocks_freed0 = self.allocator.blocks_freed
        cow0 = self._c["cow_copies"].value
        while True:
            for r in list(self._running):
                if r.state is RequestState.RUNNING and r.decoding:
                    self._grow(r, self._k_for(r) + 1)
            if not self._running:
                return
            decoders = [r for r in self._running if r.decoding]
            segments: list[tuple[Request, int, int]] = []
            rows_left = self.rows - len(decoders) * self._dec_rows
            for r in self._running:
                if rows_left <= 0:
                    break
                if not r.decoding:
                    # recurrent state goes once per row: one row per slot
                    cap = S if self._rec else rows_left * S
                    n = min(cap, len(r.context) - r.prefilled)
                    segments.append((r, r.prefilled, n))
                    rows_left -= -(-n // S)
            if not self._has_paged or self._cow_pass(decoders, segments):
                break
        phases.append(("plan", p0, tel.stamp()))

        # drafts after the plan is stable: no proposal is spent on a request
        # that growth or copy-on-write preempted; the draft pool is private
        drafts: dict[int, list[int]] = {}
        draft_dt = 0.0
        if self.draft is not None and decoders:
            t_d0 = tel.now()
            drafts = self.draft.propose([(r.rid, r.slot, r.context, r.next_token,
                                          self._k_for(r)) for r in decoders])
            draft_dt = tel.now() - t_d0
            self._h_draft_round.observe(draft_dt)
            self._c_draft_time.add(draft_dt)

        p0 = tel.stamp()
        bt, slot_ids, pos, ctx, tok = self._in.arrays()
        bt.fill(-1)
        slot_ids.fill(0)
        pos.fill(-1)
        tok.fill(0)
        for r in self._running:
            bt[r.slot, : len(r.blocks)] = r.blocks
        row = 0

        def fill(seq, start_pos, slot):
            nonlocal row
            cells = []
            for j, t in enumerate(seq):
                rr, cc = row + j // S, j % S
                slot_ids[rr] = slot
                pos[rr, cc] = start_pos + j
                tok[rr, cc] = t
                cells.append((rr, cc))
            row += -(-len(seq) // S)
            return cells

        verify_cells = {r.rid: fill([r.next_token] + drafts.get(r.rid, []), len(r.context),
                                    r.slot) for r in decoders}
        last_cell: dict[int, tuple[int, int]] = {}
        n_prefill = 0
        for r, start, n in segments:
            last_cell[r.rid] = fill(r.context[start : start + n], start, r.slot)[-1]
            n_prefill += n
        ctx[:] = pos.max(axis=1) + 1

        # quality: 1 in quality_sample_every steps (step 0 too) runs the probed step
        probe_now = (self._quality is not None
                     and self._step_i % tel.cfg.quality_sample_every == 0)
        t_dispatch = tel.now()
        p1 = tel.stamp()
        phases.append(("pack", p0, p1))
        logits, extras, flat_probes = self._run_step(probe_now)
        t_done = tel.now()
        phases.append(("replay", p1, tel.stamp()))
        self._c_target_time.add(t_done - t_dispatch)
        p0 = tel.stamp()
        probes = None if flat_probes is None else self._unpack_probes(flat_probes)
        finishing = [(r, last_cell[r.rid]) for r, start, n in segments
                     if start + n >= len(r.context) and r.next_token is None]
        if self.spec is not None:
            # greedy only: one copy of every cell's argmax to the host
            am = logits.argmax(dim=-1).cpu().numpy()
            picks = {r.rid: int(am[cell]) for r, cell in finishing}
        else:
            sampled = [(r, verify_cells[r.rid][0]) for r in decoders] + finishing
            picks = dict(zip((r.rid for r, _ in sampled), self._sample(logits, sampled)))
        p1 = tel.stamp()
        phases.append(("sample", p0, p1))

        n_cells = int((pos >= 0).sum())  # from the host's array: no device read
        self._count("packed_steps")
        self._count("packed_tokens", n_cells)
        self._count("prefill_tokens", n_prefill)
        self._count("prefill_chunks", len(segments))
        if decoders:
            self._count("decode_steps")
        if decoders and segments:
            self._count("mixed_steps")

        shadow_pick = shadow_args = None
        if (self._quality is not None and decoders
                and self._step_i % tel.cfg.quality_shadow_every == 0):
            # the deepest committed context has the most decode positions to audit
            shadow_pick = max(decoders, key=lambda q: len(q.context))
        for r in decoders:
            cells = verify_cells[r.rid]
            if r is shadow_pick:
                # the first verify cell's logits condition on context +
                # [next_token], the prefix the shadow forward replays
                shadow_args = (r, logits[cells[0]].float().cpu().numpy(), len(r.context) + 1)
            r.context.append(r.next_token)
            r.prefilled += 1  # the segment's first cell wrote it
            if self.spec is None:
                r.next_token = picks[r.rid]
                r.generated.append(r.next_token)
                self._count("decode_slot_tokens")
                tel.tokens_committed(r.rid, 1)
                continue
            d = drafts.get(r.rid, [])
            committed = greedy_verify([int(am[c]) for c in cells], d, r.eos_id)
            # every committed token but the last matched its draft, whose KV
            # this step wrote; the last is the new pending next_token
            r.context.extend(committed[:-1])
            r.prefilled += len(committed) - 1
            r.next_token = committed[-1]
            r.generated.extend(committed)
            # the last committed token counts as accepted when it is an EOS
            # that agreed with its draft
            n_acc = len(committed) - 1
            if n_acc < len(d) and committed[-1] == d[n_acc]:
                n_acc += 1
            self._count("spec_rounds")
            self._count("drafted_tokens", len(d))
            self._count("accepted_tokens", n_acc)
            self._count("rolled_back_tokens", len(d) - n_acc)
            self._count("decode_slot_tokens", len(committed))
            self._h_accept.observe(n_acc)
            if self._quality is not None and n_acc < len(d):
                # acceptance attribution: the draft position that broke first
                self._h_first_reject.observe(float(n_acc))
            tel.tokens_committed(r.rid, len(committed))
            tel.request_event(r.rid, "verify_round", drafted=len(d), accepted=n_acc,
                              committed=len(committed))
            self._rollback(r)
            if self._rec and len(committed) < len(cells):
                # the step stored the state after the row's last cell; the
                # consumed cells are next_token + committed[:-1]
                self._commit_state(extras, cells[0][0], r.slot, len(committed) - 1)
            self.draft.sync(r.slot, len(r.context))
        for r, start, n in segments:
            r.prefilled = start + n
            tel.request_event(r.rid, "prefill_chunk", start=start, n=n)
            if r.decoding and r.next_token is None:
                r.next_token = picks[r.rid]
                r.generated.append(r.next_token)
                tel.first_token(r.rid)
        for r in self._running:
            self._register_full_blocks(r)  # publish before anyone finishes
            if self._has_paged:
                if self.release_window:
                    self._release_windowed(r)
                self._g_live_peak.set_max(sum(1 for b in r.blocks if b >= 0))
        for r in [r for r in self._running if r.done]:
            self._finish(r, results)
        if probes is not None:
            self._quality.ingest(probes)
        if shadow_args is not None:
            self._shadow_probe(*shadow_args)
        self._step_i += 1
        if tel.enabled:
            dec_rows = len(decoders) * self._dec_rows
            phases.append(("commit", p1, tel.stamp()))
            marks = (self.graph.regions.names
                     if tel.fence and not probe_now and self.graph is not None else ())
            tel.step_record(
                host_s=(t_dispatch - t_host0 - draft_dt) + (tel.now() - t_done),
                device_s=t_done - t_dispatch, cells=n_cells, budget=self.token_budget,
                decode_rows=0 if self.spec else dec_rows,
                verify_rows=dec_rows if self.spec else 0,
                prefill_rows=sum(-(-n // S) for _, _, n in segments),
                blocks_allocated=self.allocator.blocks_allocated - blocks_alloc0,
                blocks_freed=self.allocator.blocks_freed - blocks_freed0,
                blocks_copied=self._c["cow_copies"].value - cow0,
                phases=phases,
                region_marks=marks or None)

    def _run_step(self, probe: bool = False):
        """Copy the packed inputs to the device and run the step, or with
        ``probe`` the probed step (graph replay or eager; a graph is captured
        before the ``packed_step`` span opens). Returns its logits, (rows, S,
        vocab) float32, its per-layer ``*_steps`` transients, and the probed
        step's probes packed in one tensor (``_unpack_probes``) or None.
        Under ``fence`` it waits for the step, so the step record's device
        time is the step's."""
        inputs = self._in.upload()
        graph = self.probe_graph if probe else self.graph
        if graph is not None:
            graph.capture(self.pools)
        with self.telemetry.annotate("packed_step"):
            if graph is not None:
                out = graph(self.pools)
            else:
                fn = self._probe_step if probe else self._packed_fn
                out = fn(self.params, self.pools, *inputs)[1]
            if self.telemetry.fence and self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        (logits, extras), flat = out if probe else (out, None)
        self.last_logits = logits
        return logits, extras, flat

    @torch.inference_mode()
    def _probe_step(self, params, pools, *inputs):
        """The probed step with its probes packed into one float32 tensor
        (so that they come to the host in one copy); their keys and shapes
        go to ``_probe_layout``. Returns (pools, (logits, flat probes))."""
        pools, logits, probes = self._probed_fn(params, pools, *inputs)
        self._probe_layout = [(k, tuple(v.shape)) for k, v in probes.items()]
        flat = torch.cat([v.float().reshape(-1) for v in probes.values()])
        return pools, (logits, flat)

    def _unpack_probes(self, flat: torch.Tensor) -> dict[str, np.ndarray]:
        """The probes as {site/stat: numpy array}, in one copy to the host."""
        host = flat.cpu().numpy()
        out, at = {}, 0
        for key, shape in self._probe_layout:
            n = int(np.prod(shape, dtype=np.int64))
            out[key] = host[at : at + n].reshape(shape)
            at += n
        return out

    @torch.inference_mode()
    def _shadow_probe(self, r: Request, served: np.ndarray, prefix_len: int) -> None:
        """The shadow quality probe (quality level, sampled): ``r``'s
        committed context, zero-padded to ``cache_len``, through a cache-free
        forward on the shadow parameters (causality makes the padding inert
        for every position read). Records the logit KL and top-1 agreement
        at the probed decode position against the serving step's own logits,
        and the teacher-forced greedy agreement over the committed decode
        window."""
        toks = r.context[: self._shadow_len]
        m = len(toks)
        if m < 2:
            return
        padded = torch.zeros((1, self._shadow_len), dtype=torch.int32)
        padded[0, :m] = torch.tensor(toks, dtype=torch.int32)
        out = self.model.apply(self._shadow_params, {"tokens": padded.to(self.device)})
        sl = out.logits[0, :m, : self.model.cfg.vocab_size]
        i = prefix_len - 1
        if 0 <= i < m:
            row = sl[i].float().cpu().numpy()
            p, q = _softmax(served), _softmax(row)
            kl = max(float(np.sum(p * (np.log(p + 1e-12) - np.log(q + 1e-12)))), 0.0)
            self._h_shadow_kl.observe(kl)
            self._g_shadow_top1.set(float(int(np.argmax(served)) == int(np.argmax(row))))
            self.telemetry.quality_counter("numerics_shadow_logit_kl", kl)
        start = max(len(r.prompt) - 1, 0)
        if m - 1 > start:
            pred = sl[start : m - 1].argmax(dim=-1).cpu().numpy()  # first maximum, as numpy's
            ref = np.asarray(toks[start + 1 : m])
            self._g_shadow_agree.set(float((pred == ref).mean()))
        self._c_shadow.add()

    def _sample(self, logits: torch.Tensor, cells: list[tuple[Request, tuple[int, int]]]
                ) -> list[int]:
        """One token per (request, cell): greedy takes the first maximal
        logit of every cell in one argmax; with a temperature each request
        takes ``argmax(logits / T + g)``, g its own Gumbel noise, which is
        ``jax.random.categorical``'s draw. One copy to the host either way."""
        if not cells:
            return []
        if self.sc.temperature <= 0:
            am = logits.argmax(dim=-1).cpu().numpy()
            return [int(am[rw, cc]) for _, (rw, cc) in cells]
        rows = torch.stack([logits[rw, cc] for _, (rw, cc) in cells])
        noise = torch.stack([self._gumbel(r, rows.shape[-1]) for r, _ in cells])
        return (rows / self.sc.temperature + noise).argmax(dim=-1).tolist()

    def _gumbel(self, r: Request, vocab: int) -> torch.Tensor:
        """Standard Gumbel noise (vocab,) float32 from ``r``'s generator:
        ``-log(-log(u))`` with u uniform in [tiny, 1), as ``jax.random.gumbel``
        draws it, so it stays finite."""
        tiny = torch.finfo(torch.float32).tiny
        u = torch.empty(vocab, dtype=torch.float32, device=self.device)
        u.uniform_(tiny, 1.0, generator=r.gen)
        return -torch.log(-torch.log(u))

    def _cow_pass(self, decoders, segments) -> bool:
        """Replace every block this step writes whose refcount exceeds 1 by a
        private copy. Returns False if making room preempted somebody (the
        caller's plan is stale and is rebuilt)."""
        bs = self.pcfg.block_size
        writes = [(r, len(r.context) // bs, (len(r.context) + self._k_for(r)) // bs)
                  for r in decoders]
        writes += [(r, start // bs, (start + n - 1) // bs) for r, start, n in segments]
        copies: list[tuple[Request, int, int]] = []
        plan_live = True
        for r, lo, hi in writes:
            if r.state is not RequestState.RUNNING:
                continue
            for j in range(lo, hi + 1):
                bid = r.blocks[j]
                if self.allocator.refcount(bid) <= 1:
                    continue
                new, preempted = self._alloc_one(r)
                plan_live &= not preempted
                copies.append((r, bid, new))
                r.blocks[j] = new
                self.allocator.free([bid])
        copies = [(r, s, d) for r, s, d in copies if r.state is RequestState.RUNNING]
        self._count("cow_copies", len(copies))
        if copies:  # in place: a captured step holds the pools' addresses
            copy_blocks(self.pools, [s for _, s, _ in copies], [d for _, _, d in copies])
        return plan_live

    def _commit_state(self, extras: list[dict], row: int, slot: int, step: int) -> None:
        """The corrective commit: every recurrent layer's state at cell
        ``step`` of grid row ``row`` (the step's ``*_steps`` transients)
        over ``slot``'s state, in place."""
        for pool, steps in zip(self.pools, extras):
            for key, v in steps.items():
                pool[key[: -len("_steps")]][slot].copy_(v[row, step])

    def _blocks_for(self, n_tokens: int) -> int:
        """Blocks to reserve for an ``n_tokens`` context: none when no layer
        is paged (recurrent state is slot-major, pinned by the slot)."""
        if not self._has_paged:
            return 0
        return blocks_needed(n_tokens, self.pcfg.block_size)

    def _rollback(self, r: Request) -> None:
        """Free the blocks a verify segment grew that hold only rejected
        drafts: all past ``blocks_needed(len(context) + 1)`` (the context
        and the pending next_token). Rejected writes inside a kept block sit
        above the horizon and are overwritten before anything reads them;
        the freed tail blocks were never registered or shared."""
        keep = self._blocks_for(len(r.context) + 1)
        if len(r.blocks) > keep:
            r.blocks = self.allocator.truncate(r.blocks, keep)

    def _release_windowed(self, r: Request) -> None:
        """Free the blocks no future query of ``r`` can attend. With window
        W a query at position q sees keys above q - W, and every future query
        sits at ``prefilled`` or later, so block j (tokens [j bs, (j + 1) bs))
        is dead once (j + 1) bs <= prefilled - W + 1. A freed entry stays a
        -1 hole in the logical table; rollback and growth only touch the
        tail, never a hole."""
        drop = max(0, r.prefilled - self.release_window + 1) // self.pcfg.block_size
        for j in range(min(drop, len(r.blocks))):
            if r.blocks[j] >= 0:
                self.allocator.free([r.blocks[j]])
                r.blocks[j] = -1

    def _grow(self, r: Request, n_tokens: int = 1) -> None:
        while self._blocks_for(len(r.context) + n_tokens) > len(r.blocks):
            got, _ = self._alloc_one(r)
            r.blocks.append(got)

    def _alloc_one(self, r: Request) -> tuple[int, bool]:
        """One block for ``r``, preempting the youngest other request until
        the allocator can serve. Returns (block id, whether it preempted)."""
        preempted = False
        while True:
            got = self.allocator.alloc(1)
            if got is not None:
                self._note_occupancy()
                return got[0], preempted
            victims = [v for v in self._running if v is not r]
            if not victims:
                raise RuntimeError(
                    f"request {r.rid} cannot grow: pool of {self.pcfg.n_blocks} "
                    "blocks is exhausted and there is nothing left to preempt")
            self._preempt(victims[-1])
            preempted = True

    def _register_full_blocks(self, r: Request) -> None:
        if not self.allocator.prefix_cache:
            return
        bs = self.pcfg.block_size
        full = r.prefilled // bs
        h = r.block_hashes[-1] if r.block_hashes else self._hash_seed
        while len(r.block_hashes) < full:
            j = len(r.block_hashes)
            h = chain_hash(h, r.context[j * bs : (j + 1) * bs])
            r.block_hashes.append(h)
            self.allocator.register(h, r.blocks[j])

    def _preempt(self, r: Request) -> None:
        # tail first, so a cached chain ages out leaf before root; windowed
        # holes were freed when they were released
        self.allocator.free([b for b in reversed(r.blocks) if b >= 0])
        r.blocks, r.block_hashes = [], []
        self._slot_free.append(r.slot)
        r.slot = -1
        r.prefilled = 0
        r.state = RequestState.PREEMPTED
        self._running.remove(r)
        self._queue.appendleft(r)
        # serving_preemptions counts once here; JAX adds to it twice (in
        # Scheduler._preempt and in Telemetry.request_preempted)
        self.telemetry.request_preempted(r.rid)

    def _finish(self, r: Request, results: dict) -> None:
        self.allocator.free([b for b in reversed(r.blocks) if b >= 0])
        r.blocks, r.block_hashes = [], []
        self._slot_free.append(r.slot)
        r.slot = -1
        r.state = RequestState.FINISHED
        self._running.remove(r)
        results[r.rid] = r.output()
        self.telemetry.request_finished(r.rid, n_generated=len(r.generated))
