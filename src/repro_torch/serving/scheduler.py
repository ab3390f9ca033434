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

Not ported yet: sliding-window and recurrent cache policies, telemetry and
quality probes.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque

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
)
from repro_torch.serving.speculative import (DraftRunner, greedy_verify, make_packed_fn,
                                              rejection_sample)

__all__ = ["RequestState", "Request", "Scheduler"]

_COUNTERS = ("packed_steps", "decode_steps", "prefill_chunks", "mixed_steps",
             "decode_slot_tokens", "prefill_tokens", "packed_tokens", "prefix_hits",
             "prefix_hit_tokens", "prefill_skipped", "cow_copies", "preemptions",
             "spec_rounds", "drafted_tokens", "accepted_tokens", "rolled_back_tokens")


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
    segment row, ``prefix_cache`` turns on prefix sharing.

    ``graph``: None captures the packed step (and a draft's steps) as CUDA
    graphs on CUDA and runs them eagerly on the CPU; False runs them eagerly;
    True demands the graphs (and raises on the CPU).

    ``draft`` (speculative configs): ``(model, params)`` or ``(model,
    params, spec)``, e.g. a ``load_quantized`` artifact; the spec's KV policy
    sizes the draft pool.
    """

    def __init__(self, model, params, sc, slots: int = 8, draft=None,
                 graph: bool | None = None):
        policies = model.cache_policies()
        if not all(p.kind == "paged_kv" for p in policies):
            raise NotImplementedError("only paged_kv cache policies are ported")
        self.model, self.params, self.sc, self.slots = model, params, sc, slots
        self.device = next(params.parameters()).device
        if graph is None:
            graph = self.device.type == "cuda"
        elif graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph step needs the card; params are on {self.device}")
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
                token_budget=self.spec.draft_token_budget, graph=graph)
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
        self.allocator = BlockAllocator(n_blocks, prefix_cache=sc.prefix_cache)
        self._hash_seed = prefix_seed(
            family=model.cfg.family, n_layers=model.cfg.n_layers,
            n_kv_heads=model.cfg.n_kv_heads, head_dim=model.cfg.head_dim,
            kv_quant=sc.kv_quant, cache_dtype=str(sc.cache_dtype),
            block_size=sc.block_size)
        self._queue: deque[Request] = deque()
        self._running: list[Request] = []
        self._slot_free = list(range(slots - 1, -1, -1))
        self._next_rid = 0
        self.counters = dict.fromkeys(_COUNTERS, 0)
        self.peak_occupancy = 0.0
        self._packed_fn = make_packed_fn(model)
        self._in = StepInputs(((slots, max_blk), (rows,), (rows, self.seg_width), (rows,),
                               (rows, self.seg_width)), self.device)
        self.graph = (GraphStep(self._packed_fn, params, self.pools, self._in.dev,
                                packed_idle(self._in.dev)) if graph else None)
        self.last_logits: torch.Tensor | None = None  # (rows, S, vocab) of the last step

    @property
    def stats(self) -> dict:
        d = dict(self.counters)
        d["peak_occupancy"] = self.peak_occupancy
        d["lut_kernel_calls"] = kr.kernel_calls()
        d["lut_jnp_calls"] = kr.jnp_calls()
        d["lut_fallbacks"] = kr.fallback_count()
        d["outlier_kernel_calls"] = kr.detect_kernel_calls()
        d["outlier_jnp_calls"] = kr.detect_jnp_calls()
        d["graph_capture_s"] = None if self.graph is None else self.graph.capture_s
        if self.draft is not None:
            d["draft_capture_s"] = self.draft.capture_s
        return d

    def _count(self, key: str, n: int = 1) -> None:
        self.counters[key] += n

    def _note_occupancy(self) -> None:
        self.peak_occupancy = max(self.peak_occupancy, self.allocator.occupancy)

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
        admitted = self._refill_slots()
        for r in [r for r in self._running if r.done]:
            self._finish(r, results)
        if self._running:
            self._packed_once(results)
            return True
        if self._queue and not admitted:
            r = self._queue[0]
            need = blocks_needed(len(r.context) + 1, self.pcfg.block_size)
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
            need = blocks_needed(len(r.context) + 1, bs)
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
            if self.draft is not None:
                self.draft.reset(r.slot)
            if shared:
                self._count("prefix_hits")
                self._count("prefix_hit_tokens", len(shared) * bs)
                self._count("prefill_skipped", r.prefilled)
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

    def _packed_once(self, results: dict) -> None:
        """Assemble and run one grid: decode or verify segments first, then
        prefill segments FCFS over the remaining rows."""
        S = self.seg_width
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
                    n = min(rows_left * S, len(r.context) - r.prefilled)
                    segments.append((r, r.prefilled, n))
                    rows_left -= -(-n // S)
            if self._cow_pass(decoders, segments):
                break

        # drafts after the plan is stable: no proposal is spent on a request
        # that growth or copy-on-write preempted; the draft pool is private
        drafts: dict[int, list[int]] = {}
        if self.draft is not None and decoders:
            drafts = self.draft.propose([(r.rid, r.slot, r.context, r.next_token,
                                          self._k_for(r)) for r in decoders])

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

        logits = self._run_step()
        finishing = [(r, last_cell[r.rid]) for r, start, n in segments
                     if start + n >= len(r.context) and r.next_token is None]
        if self.spec is not None:
            # greedy only: one copy of every cell's argmax to the host
            am = logits.argmax(dim=-1).cpu().numpy()
            picks = {r.rid: int(am[cell]) for r, cell in finishing}
        else:
            sampled = [(r, verify_cells[r.rid][0]) for r in decoders] + finishing
            picks = dict(zip((r.rid for r, _ in sampled), self._sample(logits, sampled)))

        self._count("packed_steps")
        self._count("packed_tokens", int((pos >= 0).sum()))
        self._count("prefill_tokens", n_prefill)
        self._count("prefill_chunks", len(segments))
        if decoders:
            self._count("decode_steps")
        if decoders and segments:
            self._count("mixed_steps")

        for r in decoders:
            cells = verify_cells[r.rid]
            r.context.append(r.next_token)
            r.prefilled += 1  # the segment's first cell wrote it
            if self.spec is None:
                r.next_token = picks[r.rid]
                r.generated.append(r.next_token)
                self._count("decode_slot_tokens")
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
            self._rollback(r)
            self.draft.sync(r.slot, len(r.context))
        for r, start, n in segments:
            r.prefilled = start + n
            if r.decoding and r.next_token is None:
                r.next_token = picks[r.rid]
                r.generated.append(r.next_token)
        for r in self._running:
            self._register_full_blocks(r)
        for r in [r for r in self._running if r.done]:
            self._finish(r, results)

    def _run_step(self) -> torch.Tensor:
        """Copy the packed inputs to the device and run the step (graph
        replay or eager). Returns its logits, (rows, S, vocab) float32."""
        inputs = self._in.upload()
        if self.graph is not None:
            self.last_logits = self.graph(self.pools)
        else:
            _, self.last_logits = self._packed_fn(self.params, self.pools, *inputs)
        return self.last_logits

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

    def _rollback(self, r: Request) -> None:
        """Free the blocks a verify segment grew that hold only rejected
        drafts: all past ``blocks_needed(len(context) + 1)`` (the context
        and the pending next_token). Rejected writes inside a kept block sit
        above the horizon and are overwritten before anything reads them;
        the freed tail blocks were never registered or shared."""
        keep = blocks_needed(len(r.context) + 1, self.pcfg.block_size)
        if len(r.blocks) > keep:
            r.blocks = self.allocator.truncate(r.blocks, keep)

    def _grow(self, r: Request, n_tokens: int = 1) -> None:
        while blocks_needed(len(r.context) + n_tokens, self.pcfg.block_size) > len(r.blocks):
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
        self.allocator.free(list(reversed(r.blocks)))
        r.blocks, r.block_hashes = [], []
        self._slot_free.append(r.slot)
        r.slot = -1
        r.prefilled = 0
        r.state = RequestState.PREEMPTED
        self._running.remove(r)
        self._queue.appendleft(r)
        self._count("preemptions")

    def _finish(self, r: Request, results: dict) -> None:
        self.allocator.free(list(reversed(r.blocks)))
        r.blocks, r.block_hashes = [], []
        self._slot_free.append(r.slot)
        r.slot = -1
        r.state = RequestState.FINISHED
        self._running.remove(r)
        results[r.rid] = r.output()
