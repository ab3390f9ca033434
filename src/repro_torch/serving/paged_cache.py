"""Paged K-Means KV cache: block pool helpers and the host-side allocator
(port of ``repro/serving/paged_cache.py``).

Per attention layer the pool holds float pages ``pages_k`` / ``pages_v``
(n_blocks, block_size, KV, hd) in the cache dtype, or int4 K-Means pages:
``pages_k_idx`` / ``pages_v_idx`` (n_blocks, block_size, KV, hd/2) uint8,
``pages_k_scale`` / ``pages_v_scale`` (n_blocks, block_size, KV, 1) float32
and the 16-entry ``kv_codebook``.
Token position ``p`` of a request lives at ``(table[p // block_size],
p % block_size)``. Tables and context lengths are attached per call
(``attach_tables``) and stripped afterwards (``detach_tables``).

The allocator is the JAX package's, line for line: refcounted blocks, a
chain-hash prefix registry whose refcount-0 blocks park in an LRU and are
evicted only when ``alloc`` runs dry, and ``truncate`` for rollback.

Recurrent layers (Mamba, RG-LRU) hold slot-major state instead of pages:
``h`` or ``h_idx`` / ``h_scale``, and ``conv`` (``_STATE_KEYS``). The
helpers below zero a slot on admission, snapshot and restore slots for the
draft's rollback, and split a packed step's ``*_steps`` transients from the
pools; every one writes in place and passes paged layers through.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = ["PagedCacheConfig", "BlockAllocator", "CachePolicy", "attach_tables",
           "detach_tables", "blocks_needed", "chain_hash", "prefix_seed", "copy_blocks",
           "release_horizon", "windowed_block_cap", "recurrent_state_keys", "zero_state_slot",
           "snapshot_state", "restore_state", "restore_state_slot", "split_step_extras"]

_TABLE_KEYS = ("block_tables", "ctx_lens", "token_slots")

# per-slot recurrent state (mamba / RG-LRU): what the scheduler zeroes on
# (re-)admission and the draft snapshots and restores on rollback; the
# static "state_codebook" is not state
_STATE_KEYS = ("h", "conv", "h_idx", "h_scale")


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """Per-layer cache descriptor for the scheduler: ``paged_kv`` keeps every
    block, ``windowed_paged`` (sliding-window attention, ``window`` > 0)
    lets the scheduler free blocks wholly out of the window, ``recurrent``
    (Mamba, RG-LRU) costs no blocks and pins one state slot per request;
    speculation composes through the packed step's per-cell state
    trajectories and a corrective commit, prefix sharing does not apply."""

    kind: str
    window: int = 0  # windowed_paged only: the layer's sliding window

    def __post_init__(self):
        if self.kind not in ("paged_kv", "windowed_paged", "recurrent"):
            raise ValueError(f"unknown cache policy kind {self.kind!r}")
        if self.kind == "windowed_paged" and self.window <= 0:
            raise ValueError("windowed_paged policy needs window > 0")


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Pool geometry. max context per request = block_size * max_blocks_per_seq."""

    block_size: int = 16
    n_blocks: int = 256
    max_blocks_per_seq: int = 16

    @property
    def max_context(self) -> int:
        return self.block_size * self.max_blocks_per_seq


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


def release_horizon(policies) -> int:
    """The window W such that blocks wholly below ``prefilled - W + 1`` may
    be freed, or 0 when nothing may ever be freed. Block ids are shared by
    every layer's pool, so one ``paged_kv`` layer pins the whole table;
    otherwise the smallest window over the windowed layers is safe for all
    of them. A stack with no paged layer holds no blocks (also 0)."""
    if any(p.kind == "paged_kv" for p in policies):
        return 0
    windows = [p.window for p in policies if p.kind == "windowed_paged"]
    return min(windows) if windows else 0


def windowed_block_cap(window: int, block_size: int) -> int:
    """Steady-state live blocks per request under a window: the window can
    straddle ``ceil(window / block_size)`` blocks, plus the partly written
    block the decode head grows into."""
    return blocks_needed(window, block_size) + 1


def prefix_seed(**pool_identity) -> bytes:
    """Root of the chain hash: the pool's layer set and quantization policy."""
    rep = repr(sorted(pool_identity.items())).encode()
    return hashlib.blake2b(rep, digest_size=16).digest()


def chain_hash(parent: bytes, tokens) -> bytes:
    """Identity of one full block: parent chain hash + this block's tokens."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.asarray(list(tokens), np.int64).tobytes())
    return h.digest()


class BlockAllocator:
    """Refcounted free-list allocator over the pool's block ids.

    A block is free (refcount 0, on the free list), live (refcount >= 1) or
    cached (refcount 0 but registered under a prefix hash: parked in an LRU,
    still matchable, evicted oldest-first when ``alloc`` needs the space).
    ``n_free`` counts free + cached blocks.

    With an enabled ``telemetry``, the allocator's state is three gauges
    read at snapshot time (``serving_blocks_free`` / ``_cached`` /
    ``_live``), and each cached block reclaimed because ``alloc`` ran dry
    adds to ``serving_block_evictions_pressure``.
    """

    def __init__(self, n_blocks: int, prefix_cache: bool = False, telemetry=None):
        self.n_blocks = n_blocks
        self.prefix_cache = prefix_cache
        self.evictions = 0
        self.blocks_allocated = 0
        self.blocks_freed = 0
        self._free = list(range(n_blocks - 1, -1, -1))
        self._ref = [0] * n_blocks
        self._hash_to_block: dict[bytes, int] = {}
        self._block_hash: dict[int, bytes] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()
        self._c_evict = None
        if telemetry is not None and telemetry.enabled:
            telemetry.gauge("serving_blocks_free", "truly-free blocks",
                            fn=lambda: len(self._free))
            telemetry.gauge("serving_blocks_cached", "cached prefix blocks (LRU)",
                            fn=lambda: len(self._lru))
            telemetry.gauge("serving_blocks_live", "blocks held live (refcount >= 1)",
                            fn=lambda: self.n_blocks - self.n_free)
            self._c_evict = telemetry.counter(
                "serving_block_evictions_pressure",
                "cached prefix blocks reclaimed because alloc ran dry")

    @property
    def n_free(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def n_cached(self) -> int:
        return len(self._lru)

    @property
    def occupancy(self) -> float:
        return 1.0 - self.n_free / self.n_blocks

    def refcount(self, block_id: int) -> int:
        return self._ref[block_id]

    def alloc(self, n: int) -> list[int] | None:
        """n block ids at refcount 1, or None (all or nothing); evicts cached
        prefix blocks only when the free list alone cannot serve."""
        if n <= 0:
            return []
        if n > self.n_free:
            return None
        while len(self._free) < n:
            self._evict_one()
        got = self._free[-n:][::-1]
        del self._free[len(self._free) - n:]
        for b in got:
            self._ref[b] = 1
        self.blocks_allocated += n
        return got

    def free(self, ids: list[int]) -> None:
        """Drop one reference per id, validating the whole list first."""
        counts: dict[int, int] = {}
        for b in ids:
            if not isinstance(b, (int, np.integer)) or not 0 <= b < self.n_blocks:
                raise ValueError(f"free of block {b!r}: out of range for pool of {self.n_blocks}")
            counts[b] = counts.get(b, 0) + 1
        for b, c in counts.items():
            if self._ref[b] < c:
                raise ValueError(
                    f"free of block {b}: {c} frees but {self._ref[b]} refs held (double free?)")
        for b in ids:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self.blocks_freed += 1
                if b in self._block_hash:
                    self._lru[b] = None
                    self._lru.move_to_end(b)
                else:
                    self._free.append(b)

    def truncate(self, ids: list[int], keep: int) -> list[int]:
        """Drop one reference from every block past the first ``keep``
        (tail first) and return the kept prefix."""
        if keep < 0:
            raise ValueError(f"truncate keep must be >= 0, got {keep}")
        self.free(list(reversed(ids[keep:])))
        return list(ids[:keep])

    def incref(self, block_id: int) -> None:
        """Add an alias to a live or cached block (never to a free one)."""
        if self._ref[block_id] == 0:
            if block_id not in self._lru:
                raise ValueError(f"incref of free block {block_id}")
            del self._lru[block_id]
        self._ref[block_id] += 1

    def register(self, prefix_hash: bytes, block_id: int) -> bool:
        """Publish a live full block under its chain hash (first writer wins)."""
        if not self.prefix_cache:
            return False
        if self._ref[block_id] <= 0:
            raise ValueError(f"register of non-live block {block_id}")
        if prefix_hash in self._hash_to_block:
            return False
        if block_id in self._block_hash:
            raise ValueError(f"block {block_id} already registered")
        self._hash_to_block[prefix_hash] = block_id
        self._block_hash[block_id] = prefix_hash
        return True

    def lookup(self, prefix_hash: bytes) -> int | None:
        return self._hash_to_block.get(prefix_hash)

    def _evict_one(self) -> None:
        bid, _ = self._lru.popitem(last=False)
        del self._hash_to_block[self._block_hash.pop(bid)]
        self._free.append(bid)
        self.evictions += 1
        if self._c_evict is not None:
            self._c_evict.add()


def recurrent_state_keys(layer: dict) -> list[str]:
    """The per-slot state arrays of one cache layer (none for a paged
    layer, which makes the helpers below pass it through)."""
    return [k for k in _STATE_KEYS if k in layer]


def zero_state_slot(pools: list[dict], slot: int) -> list[dict]:
    """Zero one slot's recurrent state in every layer, in place (a new or
    re-admitted occupant replays its context from position 0)."""
    for layer in pools:
        for k in recurrent_state_keys(layer):
            layer[k][slot].zero_()
    return pools


def snapshot_state(pools: list[dict], into: list[dict] | None = None) -> list[dict]:
    """A copy of every layer's recurrent state: into the tensors of an
    earlier snapshot ``into`` (made once, then refilled), or new ones."""
    if into is None:
        return [{k: layer[k].clone() for k in recurrent_state_keys(layer)} for layer in pools]
    for layer, snap in zip(pools, into):
        for k, v in snap.items():
            v.copy_(layer[k])
    return into


def restore_state(pools: list[dict], snapshot: list[dict]) -> list[dict]:
    """Copy a whole :func:`snapshot_state` back into ``pools``, in place."""
    for layer, snap in zip(pools, snapshot):
        for k, v in snap.items():
            layer[k].copy_(v)
    return pools


def restore_state_slot(pools: list[dict], snapshot: list[dict], slot: int) -> list[dict]:
    """Copy one slot's recurrent state from ``snapshot`` back into
    ``pools``, in place: the draft runner's speculative rollback."""
    for layer, snap in zip(pools, snapshot):
        for k in recurrent_state_keys(layer):
            layer[k][slot].copy_(snap[k][slot])
    return pools


def split_step_extras(caches: list[dict]) -> tuple[list[dict], list[dict]]:
    """A packed step's returned caches -> (persistent pools, per-layer
    ``*_steps`` transients). Recurrent layers in the packed layout return
    their state after each cell besides the state they stored; the
    scheduler reads them only for the corrective commit after a partly
    accepted verify row, so they never persist."""
    pools = [{k: v for k, v in layer.items() if not k.endswith("_steps")} for layer in caches]
    extras = [{k: v for k, v in layer.items() if k.endswith("_steps")} for layer in caches]
    return pools, extras


def copy_blocks(pools: list[dict], src, dst) -> list[dict]:
    """Copy-on-write primitive: pool rows ``src[i]`` overwrite rows ``dst[i]``
    in every layer's ``pages_*`` arrays, in place (the tensors stay the same,
    so a captured step's addresses stay valid). The two index tensors are
    made once per call."""
    dev = next(v.device for layer in pools for k, v in layer.items() if k.startswith("pages_"))
    s = torch.as_tensor(np.asarray(src), dtype=torch.long, device=dev)
    t = torch.as_tensor(np.asarray(dst), dtype=torch.long, device=dev)
    for layer in pools:
        for k, v in layer.items():
            if k.startswith("pages_"):
                v.index_copy_(0, t, v[s])
    return pools


def attach_tables(pools: list[dict], block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                  token_slots: torch.Tensor | None = None) -> list[dict]:
    """Pools + per-call tables -> caches ready for ``model.apply``.

    Per-sequence layout (``token_slots`` None): row b is one sequence. Packed
    layout: row g is one segment of scheduler slot ``token_slots[g]``;
    ``block_tables`` stays per slot and ``ctx_lens`` is per row."""
    extra = {"block_tables": block_tables.int(), "ctx_lens": ctx_lens.int()}
    if token_slots is not None:
        extra["token_slots"] = token_slots.int()
    return [layer | extra for layer in pools]


def detach_tables(caches: list[dict]) -> list[dict]:
    """Inverse of :func:`attach_tables`: only the persistent pool arrays."""
    return [{k: v for k, v in layer.items() if k not in _TABLE_KEYS} for layer in caches]
