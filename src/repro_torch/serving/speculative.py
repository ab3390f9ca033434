"""Speculative decoding with a low-bit K-Means draft model and multi-token
greedy verification (port of ``repro/serving/speculative.py``).

Each round, every decoding request drafts ``k`` greedy tokens with a cheap
draft (by default the same model quantized W3/A4 under
:data:`DEFAULT_DRAFT_SPEC`); the target verifies ``[next_token, d_1 ..
d_k]`` as ``k + 1`` cells of the scheduler's packed step and commits 1 to
``k + 1`` tokens.

* :class:`DraftRunner` owns the draft's state: a private paged pool with
  static per-slot block tables (slot ``s`` owns blocks ``[s * max_blk, (s +
  1) * max_blk)``), a host-side count per slot of the cache positions that
  agree with the request's context, a packed catch-up step for context the
  draft has not seen, and one loop of ``k + 1`` single-token forwards. On
  the card the catch-up step and the loop each run as one captured CUDA
  graph (``graph_step.py``), the loop being the counterpart of JAX's single
  ``lax.scan`` dispatch.
* The scheduler (``scheduler.py``) packs the verify cells, applies
  :func:`greedy_verify` to their argmaxes, rolls back the target's blocks
  that hold only rejected drafts and rewinds the draft with ``sync``.

Greedy verification is exact: the target's argmax after position ``i`` is
the token non-speculative greedy decoding would produce for the same
prefix, so the output equals ``speculative=None``'s token for token, as long
as a cell's logits do not depend on the other cells of the step. Temperature
sampling needs the rejection-sampling rule, which :func:`rejection_sample`
documents and refuses, as JAX does. A recurrent draft (Mamba, RG-LRU) rolls
its state back from a snapshot taken before the loop and catches up with
one multi-token row per slot (its state is gathered and stored by slot).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import numerics as nx
from repro_torch.core.qlinear import QLinearConfig
from repro_torch.core.quantspec import QuantSpec
from repro_torch.serving.graph_step import GraphStep, StepInputs, packed_idle
from repro_torch.serving.paged_cache import (attach_tables, blocks_needed, detach_tables,
                                             restore_state, restore_state_slot, snapshot_state,
                                             split_step_extras, zero_state_slot)
from repro_torch.serving.telemetry import NULL_TELEMETRY

__all__ = ["SpeculativeConfig", "DraftRunner", "greedy_verify", "rejection_sample",
           "make_packed_fn", "make_probed_packed_fn", "load_draft", "DEFAULT_DRAFT_SPEC"]


# The draft policy of the JAX package: W3 K-Means weights with a W4 guard on
# mlp/wi (the most CE-sensitive projection), A4 activations, dynamic
# Orizuru outliers and an int4 K-Means draft KV pool.
DEFAULT_DRAFT_SPEC = QuantSpec(
    base=QLinearConfig(w_bits=3, a_bits=4, detection="dynamic", outlier_frac=0.005),
    rules=[("mlp/wi", {"w_bits": 4})],
    kv_bits=4, kv_dtype="float32",
)


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """``ServeConfig.speculative``: None = off, an instance = on.

    ``k``: draft tokens per decoding request per round (the target verifies
    ``k + 1`` cells). ``draft_artifact``: directory of a quantized draft
    artifact, loaded by ``load_quantized``; the engine may instead be handed
    ``draft=(model, params[, spec])``. ``draft_token_budget``: rows of the
    draft's catch-up step; 0 -> ``slots + 32``."""

    k: int = 3
    draft_artifact: str | None = None
    draft_token_budget: int = 0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")


def make_packed_fn(model, extras: bool = False):
    """The packed step: every argument has a fixed shape per engine.

      slot_ids  (G,)    scheduler slot of each segment row
      positions (G, S)  absolute token positions (-1 = padded cell)
      ctx       (G,)    write/attend horizon per row (last valid pos + 1)
      tokens    (G, S)  token ids (anything in padded cells)

    Row ``g`` writes its valid tokens' KV into ``slot_ids[g]``'s blocks and
    attends causally through that slot's block table; a recurrent layer
    gathers the row's state by slot and stores the state after its last
    valid cell (one row per slot). Returns (pools, logits (G, S, vocab)),
    or with ``extras`` (pools, (logits, the per-layer ``*_steps``
    transients of ``paged_cache.split_step_extras``))."""

    @torch.inference_mode()
    def packed_step(params, pools, bt, slot_ids, positions, ctx, tokens):
        caches = attach_tables(pools, bt, ctx, token_slots=slot_ids)
        out = model.apply(params, {"tokens": tokens}, positions=positions, caches=caches)
        pools, steps = split_step_extras(detach_tables(out.caches))
        logits = out.logits[..., : model.cfg.vocab_size]
        return pools, ((logits, steps) if extras else logits)

    return packed_step


def make_probed_packed_fn(model, extras: bool = False):
    """The ``quality`` level's packed step: :func:`make_packed_fn`'s step,
    then a probe-only forward under ``numerics.collect`` masked on
    ``positions >= 0``. Returns (pools, logits, probes), ``probes`` the flat
    ``{site/stat: tensor}`` dict, one site per quantized projection per
    layer in forward order (``"000.attn.q"`` ..); with ``extras`` the
    logits come as ``(logits, *_steps transients)``.

    The pools and logits are the untouched step's, as in JAX, where the
    probe forward's outputs are discarded. The port writes the pools in
    place, so the probe forward writes this step's KV cells again: the same
    kernels on the same inputs give the same bits, and each layer attends
    over the same cells the first forward saw. Recurrent state is not
    idempotent that way, so it is put back as the step found it before the
    probe forward, which then stores the same state again. Either way the
    pools after a probed step equal an unprobed step's bit for bit."""
    packed_step = make_packed_fn(model, extras)

    @torch.inference_mode()
    def probed_step(params, pools, bt, slot_ids, positions, ctx, tokens):
        before = snapshot_state(pools)
        pools, logits = packed_step(params, pools, bt, slot_ids, positions, ctx, tokens)
        restore_state(pools, before)
        caches = attach_tables(pools, bt, ctx, token_slots=slot_ids)
        with nx.collect(mask=(positions >= 0).float()) as col:
            model.apply(params, {"tokens": tokens}, positions=positions, caches=caches)
        return pools, logits, col.out

    return probed_step


def greedy_verify(targets: list[int], drafts: list[int],
                  eos_id: int | None = None) -> list[int]:
    """The committed tokens of one verify segment. ``targets[i]`` is the
    target's argmax after verify position ``i`` (``len(drafts) + 1`` of
    them): every leading target token that agrees with its draft, then one
    more -- the first disagreement, the bonus token after a full match, or an
    EOS, after which nothing is committed. At least one token."""
    committed: list[int] = []
    for i, g in enumerate(targets):
        committed.append(int(g))
        if eos_id is not None and g == eos_id:
            break
        if i >= len(drafts) or g != drafts[i]:
            break
    return committed


def rejection_sample(*_args, **_kw):
    """Temperature-sampling acceptance (not implemented, as in JAX): accept
    ``d_i`` with probability ``min(1, p_target(d_i) / p_draft(d_i))`` and on
    rejection sample the correction from ``max(0, p_target - p_draft)``
    renormalized. Raises; the scheduler refuses ``temperature > 0``."""
    raise NotImplementedError(
        "speculative decoding with temperature > 0 needs the rejection-sampling "
        "acceptance rule (accept d_i w.p. min(1, p_target/p_draft), resample the "
        "correction from the residual); only greedy verification is implemented -- "
        "serve with temperature=0 or speculative=None")


def load_draft(directory: str, device=None):
    """A draft artifact as ``(model, params, spec)`` on ``device`` (default:
    the card)."""
    from repro_torch.core.artifact import load_quantized

    return tuple(load_quantized(directory, device=device))


class DraftRunner:
    """The draft model's serving state, mirrored onto the target scheduler's
    slots: a private paged pool with static per-slot tables, a catch-up step
    of ``budget`` one-token rows and the loop of ``k + 1`` one-token
    forwards over ``slots`` rows, plus ``pos[slot]``, the number of leading
    draft-cache positions that agree with the slot's context.

    ``graph``: None runs both steps as CUDA graphs on the card and eagerly on
    the CPU, False eagerly, True as graphs or raises. ``steps`` counts the
    draft's dispatches (catch-up steps and loops), as does the
    ``telemetry``'s ``serving_draft_steps``; each dispatch is a
    ``draft_catchup`` or ``draft_scan`` span.

    Rollback is the count: after verification ``sync(slot, len(context))``
    rewinds it, and rejected rows above the horizon are rewritten by the
    next catch-up or loop before any read can reach them (paged reads stop at
    ``ctx`` and the causal mask). ``reset`` (a new occupant) rewinds to 0: the
    draft replays the whole prompt; it never shares the target's prefix
    cache. A sliding-window draft keeps every block of its static tables:
    the window mask alone bounds what it attends. A recurrent draft (Mamba,
    RG-LRU) also restores the state of a slot whose drafts were rejected
    from a snapshot taken before the loop (``sync``), and zeroes it on
    ``reset``."""

    _CATCH_S = 32  # tokens per slot per catch-up step of a recurrent draft

    def __init__(self, model, params, *, slots: int, cache_len: int, k: int,
                 block_size: int = 16, cache_dtype="float32", kv_quant: bool = False,
                 token_budget: int = 0, graph: bool | None = None, telemetry=None):
        self._rec = any(p.kind == "recurrent" for p in model.cache_policies())
        self.model, self.params, self.k, self.slots = model, params, k, slots
        self.device = next(params.parameters()).device
        # headroom: the loop writes up to position n + k for a row whose own
        # horizon stops earlier (k_r < k near a budget end)
        draft_len = cache_len + k + 1
        self.max_blk = blocks_needed(draft_len, block_size)
        n_blocks = slots * self.max_blk
        self.pools = model.init_caches(slots, draft_len, cache_dtype, quantized=kv_quant,
                                       layout="paged", block_size=block_size,
                                       n_blocks=n_blocks, device=self.device)
        self._bt = torch.arange(n_blocks, dtype=torch.int32,
                                device=self.device).reshape(slots, self.max_blk)
        self.budget = token_budget or (slots + 32)
        if self.budget < 1:
            raise ValueError(f"draft_token_budget must be >= 1, got {self.budget}")
        self.pos = [0] * slots
        self.steps = 0
        self.telemetry = telemetry if telemetry is not None else NULL_TELEMETRY
        self._c_steps = self.telemetry.counter("serving_draft_steps",
                                               "draft device dispatches (catch-up + scan)")
        self._packed = make_packed_fn(model)
        # catch-up rows: ``budget`` one-token rows; a recurrent draft's state
        # is gathered and stored by slot, so it takes one row of
        # ``_CATCH_S`` tokens per slot instead
        rows, width = (slots, self._CATCH_S) if self._rec else (self.budget, 1)
        self._catch_in = StepInputs(((rows,), (rows, width), (rows,), (rows, width)),
                                    self.device)
        self._loop_in = StepInputs(((slots,), (slots,), (slots,)), self.device)
        # recurrent rollback: every layer's state after catch-up, before the
        # loop (the state at each slot's context length), restored per slot
        self._snap = snapshot_state(self.pools) if self._rec else None
        self._snap_base: dict[int, int] | None = None
        if graph is None:
            graph = self.device.type == "cuda"
        elif graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph step needs the card; params are on {self.device}")
        self._catch_graph = self._loop_graph = None
        if graph:
            args = (self._bt, *self._catch_in.dev)
            self._catch_graph = GraphStep(self._packed, params, self.pools, args,
                                          packed_idle(args))
            slot_ids, tok0, pos0 = self._loop_in.dev
            self._loop_graph = GraphStep(self._loop, params, self.pools, self._loop_in.dev,
                                         (torch.zeros_like(slot_ids), torch.zeros_like(tok0),
                                          torch.full_like(pos0, -1)))

    @property
    def capture_s(self) -> float | None:
        """Seconds spent capturing the two graphs (None before any capture)."""
        got = [g.capture_s for g in (self._catch_graph, self._loop_graph)
               if g is not None and g.capture_s is not None]
        return sum(got) if got else None

    # ------------------------------------------------------------ the steps
    @torch.inference_mode()
    def _loop(self, params, pools, slot_ids, tok0, pos0):
        """``k + 1`` one-token forwards over every row: iteration j feeds each
        row's current token at ``pos`` and proposes the next by argmax, so
        from (next_token, n) it drafts d_1 .. d_{k+1} while writing
        next_token, d_1 .. d_k. The last write keeps a fully accepted
        request's draft cache caught up; its proposal is discarded. Rows at
        pos -1 write only scratch cells. Returns (pools, drafts (k + 1, R))."""
        tok, pos, drafts = tok0, pos0, []
        for _ in range(self.k + 1):
            valid = pos >= 0
            ctx = torch.where(valid, pos + 1, 0)
            pools, logits = self._packed(params, pools, self._bt, slot_ids, pos[:, None], ctx,
                                         tok[:, None])
            tok = logits[:, 0].argmax(dim=-1).int()
            pos = torch.where(valid, pos + 1, -1)
            drafts.append(tok)
        return pools, torch.stack(drafts)

    def _dispatch(self, span: str, fn, graph: GraphStep | None, inputs: StepInputs,
                  static=()):
        """Upload ``inputs`` and run one step: ``fn(params, pools, *static,
        *inputs)``, or its graph (captured first, outside the span). Returns
        the step's output."""
        dev = inputs.upload()
        self.steps += 1
        self._c_steps.add()
        if graph is not None:
            graph.capture(self.pools)
        with self.telemetry.annotate(span):
            if graph is not None:
                return graph(self.pools)
            return fn(self.params, self.pools, *static, *dev)[1]

    # ------------------------------------------------------------- lifecycle
    def reset(self, slot: int) -> None:
        """New occupant for ``slot``: nothing in the draft cache is valid."""
        self.pos[slot] = 0
        if self._rec:
            zero_state_slot(self.pools, slot)

    def sync(self, slot: int, n_valid: int) -> None:
        """After verification: positions >= ``n_valid`` were rejected drafts
        (or never written); catch-up rewrites them. A recurrent draft holds
        one state, which the loop advanced past the rejection: it goes back
        to the snapshot (the state at the old context length) and catch-up
        replays the accepted tokens. Full acceptance keeps the advanced
        state."""
        if self._rec and n_valid < self.pos[slot]:
            if self._snap_base is None:  # no snapshot yet: nothing proposed
                self.reset(slot)
                return
            restore_state_slot(self.pools, self._snap, slot)
            self.pos[slot] = min(self._snap_base.get(slot, 0), n_valid)
        else:
            self.pos[slot] = min(self.pos[slot], n_valid)

    # -------------------------------------------------------------- proposal
    def propose(self, reqs: list[tuple[int, int, list[int], int, int]]) -> dict[int, list[int]]:
        """Draft up to ``k`` greedy tokens per request.

        ``reqs``: (rid, slot, context, next_token, k_r) per decoding request;
        ``context`` is what the target cache holds, ``next_token`` the
        sampled token the verify segment starts with. Returns {rid: [d_1 ..
        d_{k_r}]} (k_r = 0 entries omitted; their rows still run the loop,
        whose writes keep the draft cache warm).

        Context the draft has not seen is packed FCFS into catch-up steps of
        ``budget`` rows (a fresh admission replays its prompt; a recurrent
        draft packs one row of up to ``_CATCH_S`` tokens per slot); then one
        loop drafts for every row at once, and its drafts come to the host in
        one copy."""
        if not reqs:
            return {}
        pending = [[slot, list(context[self.pos[slot]:]), self.pos[slot]]
                   for _rid, slot, context, _nt, _k in reqs if self.pos[slot] < len(context)]
        if self._rec:
            self._catch_up_rows(pending)
            # the state at each slot's context length, for sync's rollback
            snapshot_state(self.pools, into=self._snap)
            self._snap_base = {slot: len(ctx) for _r, slot, ctx, _nt, _k in reqs}
        else:
            self._catch_up_cells(pending)
        return self._draft(reqs)

    def _catch_up_cells(self, pending: list) -> None:
        """Unseen context packed FCFS into steps of ``budget`` one-token rows."""
        T = self.budget
        while pending:
            slot_ids, pos, ctx, tok = self._catch_in.arrays()
            slot_ids.fill(0)
            pos.fill(-1)
            tok.fill(0)
            row, leftover = 0, []
            for item in pending:
                slot, toks, start = item
                if row >= T:
                    leftover.append(item)
                    continue
                n = min(T - row, len(toks))
                slot_ids[row : row + n] = slot
                pos[row : row + n, 0] = range(start, start + n)
                tok[row : row + n, 0] = toks[:n]
                if n < len(toks):
                    leftover.append([slot, toks[n:], start + n])
                row += n
            ctx[:] = pos[:, 0] + 1
            self._dispatch("draft_catchup", self._packed, self._catch_graph, self._catch_in,
                           (self._bt,))
            pending = leftover

    def _catch_up_rows(self, pending: list) -> None:
        """A recurrent draft's catch-up: per step, one row per pending slot
        holding its next ``_CATCH_S`` unseen tokens."""
        S = self._CATCH_S
        while pending:
            slot_ids, pos, ctx, tok = self._catch_in.arrays()
            slot_ids.fill(0)
            pos.fill(-1)
            tok.fill(0)
            leftover = list(pending[self.slots:])
            for row, (slot, toks, start) in enumerate(pending[: self.slots]):
                n = min(S, len(toks))
                slot_ids[row] = slot
                pos[row, :n] = range(start, start + n)
                tok[row, :n] = toks[:n]
                if n < len(toks):
                    leftover.append([slot, toks[n:], start + n])
            ctx[:] = pos.max(axis=1) + 1
            self._dispatch("draft_catchup", self._packed, self._catch_graph, self._catch_in,
                           (self._bt,))
            pending = leftover

    def _draft(self, reqs) -> dict[int, list[int]]:
        """The ``k + 1``-forward loop over every request's row; its drafts
        come to the host in one copy."""
        slot_ids, tok0, pos0 = self._loop_in.arrays()
        slot_ids.fill(0)
        tok0.fill(0)
        pos0.fill(-1)
        for row, (_rid, slot, context, next_token, _k) in enumerate(reqs):
            slot_ids[row], tok0[row], pos0[row] = slot, next_token, len(context)
        dr = self._dispatch("draft_scan", self._loop, self._loop_graph,
                            self._loop_in).cpu().numpy()
        drafts: dict[int, list[int]] = {}
        for row, (rid, slot, context, _nt, k_r) in enumerate(reqs):
            if k_r > 0:
                drafts[rid] = [int(dr[j, row]) for j in range(k_r)]
            self.pos[slot] = len(context) + self.k + 1
        return drafts
