"""Serving steps as captured CUDA graphs: the port's counterpart of
``jax.jit`` of a step in ``repro/serving/``.

JAX compiles a serving step once per shape and runs it as one program.
Run eagerly, the port's step is hundreds of small PyTorch ops and kernel
launches per layer, each issued from Python. A step of fixed shape -- the
scheduler's packed step (``rows x seg_width``) and, at the ``quality``
telemetry level, its probed step, the draft model's catch-up step and its
``k + 1``-forward loop, the fixed-slot engine's ring decode step -- is
captured once by :class:`GraphStep`, on its first call, and
replayed after: its inputs live in static device buffers that the caller
fills before each call (:class:`StepInputs` for the ones the host packs),
the caches are written in place, and the outputs come back in static
buffers that the next replay overwrites.

Capture, in order:

1. a warm-up run of the step on the capture stream, over the ``idle``
   inputs the caller passes. They must leave the caches as the first replay
   finds them: inputs with no valid cell (no table entry, every position -1)
   send a paged step's writes to the scratch blocks and its recurrent
   states to the scratch slot; a ring step is warmed up on its first
   inputs, whose KV writes the first replay repeats bit for bit. Recurrent
   state is not rewritten so (a second run would advance it again), so the
   warm-up puts back every state it found. The warm-up builds and binds the
   kernels, sets their shared-memory attributes and makes the stream's
   split-kernel tickets (``kernels/build.py::tickets``) outside the graph's
   memory pool;
2. the capture itself, which runs the Python but no kernel;
3. the first replay, which does the first step's work.

With ``regions`` step 2 records a marker kernel at every region boundary
the model code marks (``telemetry.RegionMarks``); the warm-up records none.

A capture that fails raises: nothing falls back to the eager step. The
launch and dispatch counters (``kernels/build.py``,
``core/kernel_routing.py``) count Python calls, so :class:`StepCounts` takes
what the capture counted off them and adds it back once per replay; the
warm-up's counts are taken off too.
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import Counter

import torch

from repro_torch.core import kernel_routing as kr
from repro_torch.kernels import build
from repro_torch.serving.paged_cache import restore_state, snapshot_state
from repro_torch.serving.telemetry import RegionMarks

__all__ = ["GraphStep", "StepCounts", "StepInputs", "packed_idle", "pool_ptrs"]


def pool_ptrs(pools: list[dict]) -> list[tuple[str, int]]:
    """The address of every pool tensor, layer by layer."""
    return [(k, v.data_ptr()) for layer in pools for k, v in sorted(layer.items())]


class StepCounts:
    """What one run of a step adds to every launch and dispatch counter."""

    def __init__(self):
        self.delta: list[Counter] | None = None

    @staticmethod
    def counters() -> tuple[Counter, ...]:
        return (*build.COUNTERS, *kr.COUNTERS)

    @contextlib.contextmanager
    def record(self):
        """Run the body, keep what it added to the counters in ``delta`` and
        take it off them again (a capture runs no kernel)."""
        before = [Counter(c) for c in self.counters()]
        try:
            yield
            self.delta = [c - b for c, b in zip(self.counters(), before)]
        finally:
            for c, b in zip(self.counters(), before):
                c.clear()
                c.update(b)

    def add(self) -> None:
        """Count one run of the recorded step."""
        for c, d in zip(self.counters(), self.delta):
            c.update(d)


class StepInputs:
    """A step's int32 inputs: host arrays that the caller fills (pinned on
    the card) and the device tensors the step reads, the same tensors every
    step (on the CPU the two are one)."""

    def __init__(self, shapes, device: torch.device):
        cuda = device.type == "cuda"
        self.host = [torch.empty(s, dtype=torch.int32, pin_memory=cuda) for s in shapes]
        self.dev = (tuple(torch.empty(s, dtype=torch.int32, device=device) for s in shapes)
                    if cuda else tuple(self.host))
        # recorded after each upload: the next packing must not overwrite the
        # pinned arrays while a copy from them is queued
        self._copied = torch.cuda.Event() if cuda else None

    def arrays(self) -> list:
        """The host arrays as numpy views, once the last upload has read them."""
        if self._copied is not None:
            self._copied.synchronize()
        return [h.numpy() for h in self.host]

    def upload(self) -> tuple[torch.Tensor, ...]:
        """Queue the copies to the device tensors; returns them."""
        if self._copied is not None:
            for d, h in zip(self.dev, self.host):
                d.copy_(h, non_blocking=True)
            self._copied.record()
        return self.dev


class GraphStep:
    """``fn(params, pools, *inputs) -> (pools, out)`` captured as one CUDA
    graph over the static device tensors ``inputs``; calling it replays the
    graph and returns ``out``, static tensors that the next replay
    overwrites. ``idle`` holds the warm-up's inputs (see the module
    docstring), shaped as ``inputs``. With ``regions`` the capture marks
    the region boundaries in the graph (``self.regions``, a
    ``RegionMarks``).

    ``pools`` must stay the same tensors for the graph's life: they are
    written in place (copy-on-write and preemption too), and each call
    checks their addresses."""

    def __init__(self, fn, params, pools: list[dict], inputs: tuple[torch.Tensor, ...],
                 idle: tuple[torch.Tensor, ...], regions: bool = False):
        self.device = inputs[0].device
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {self.device}")
        if [t.shape for t in idle] != [t.shape for t in inputs]:
            raise ValueError("the warm-up inputs must have the step inputs' shapes")
        self.fn, self.params, self.inputs, self.idle = fn, params, inputs, idle
        self.ptrs = pool_ptrs(pools)
        self.stream = torch.cuda.Stream(self.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.counts = StepCounts()
        self.capture_s: float | None = None
        self.regions = RegionMarks() if regions else None

    def __call__(self, pools: list[dict]):
        self.capture(pools)
        self.graph.replay()
        self.counts.add()
        return self.out

    def capture(self, pools: list[dict]) -> None:
        """Warm up and capture the step unless it is captured already (the
        first call does it; a caller that times or annotates replays calls
        it first)."""
        if pool_ptrs(pools) != self.ptrs:
            raise RuntimeError("the pools a captured step writes were replaced; a graph "
                               "holds their addresses, so they must be written in place")
        if self.graph is not None:
            return
        t0 = time.perf_counter()
        states = snapshot_state(pools)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with StepCounts().record(), torch.cuda.stream(self.stream):
            self.fn(self.params, pools, *self.idle)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        restore_state(pools, states)  # the warm-up leaves no state behind
        graph = torch.cuda.CUDAGraph()
        marked = self.regions.recording() if self.regions else contextlib.nullcontext()
        with self.counts.record(), _no_gc(), torch.cuda.graph(graph, stream=self.stream), marked:
            out_pools, self.out = self.fn(self.params, pools, *self.inputs)
        if pool_ptrs(out_pools) != self.ptrs:
            raise RuntimeError("the captured step returned other pool tensors than it was given")
        self.graph = graph
        self.idle = None
        self.capture_s = time.perf_counter() - t0


@contextlib.contextmanager
def _no_gc():
    """No automatic garbage collection in the body. A dead graph still held
    by a reference cycle (an engine and its telemetry's gauge callbacks
    form one) that the collector frees during a capture destroys its graph
    there, which CUDA does not permit while a stream captures: the capture
    fails."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def packed_idle(inputs: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """Warm-up inputs of a packed step ``(bt, slot_ids, pos, ctx, tok)`` with
    no valid cell: its pool writes all go to the scratch blocks."""
    bt, slot_ids, pos, ctx, tok = inputs
    return (torch.full_like(bt, -1), torch.zeros_like(slot_ids), torch.full_like(pos, -1),
            torch.zeros_like(ctx), torch.zeros_like(tok))
