"""The packed step as one captured CUDA graph: the port's counterpart of
``jax.jit(make_packed_fn(model))`` in ``repro/serving/scheduler.py``.

JAX compiles the packed step once per shape and runs it as one program.
Run eagerly, the port's step is hundreds of small PyTorch ops and kernel
launches per layer, each issued from Python. A scheduler's step has one
shape (``rows x seg_width``), so :class:`GraphStep` captures it once, on
its first call, and replays it after: the five step inputs live in static
device buffers that the caller fills before each call, the pools are
written in place, and the logits come back in one static buffer that the
next replay overwrites.

Capture, in order:

1. a warm-up run of the step on the capture stream, over inputs with no
   valid cell (no table entry, every position -1), so its only pool writes
   go to the scratch blocks. It builds and binds the kernels, sets their
   shared-memory attributes and makes the stream's split-kernel tickets
   (``kernels/build.py::tickets``) outside the graph's memory pool;
2. the capture itself, which runs the Python but no kernel;
3. the first replay, which does the first step's work.

A capture that fails raises: nothing falls back to the eager step. The
launch and dispatch counters (``kernels/build.py``,
``core/kernel_routing.py``) count Python calls, so :class:`StepCounts` takes
what the capture counted off them and adds it back once per replay; the
warm-up's counts are taken off too.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch

from repro_torch.core import kernel_routing as kr
from repro_torch.kernels import build

__all__ = ["GraphStep", "StepCounts", "pool_ptrs"]


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


class GraphStep:
    """``fn(params, pools, *inputs) -> (pools, logits)`` captured as one CUDA
    graph over the static device tensors ``inputs``; calling it replays the
    graph and returns the static logits.

    ``pools`` must stay the same tensors for the graph's life: they are
    written in place (copy-on-write and preemption too), and each call
    checks their addresses."""

    def __init__(self, fn, params, pools: list[dict], inputs: tuple[torch.Tensor, ...]):
        self.device = inputs[0].device
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs CUDA tensors, got {self.device}")
        self.fn, self.params, self.inputs = fn, params, inputs
        self.ptrs = pool_ptrs(pools)
        self.stream = torch.cuda.Stream(self.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.logits: torch.Tensor | None = None
        self.counts = StepCounts()
        self.capture_s: float | None = None

    def __call__(self, pools: list[dict]) -> torch.Tensor:
        if pool_ptrs(pools) != self.ptrs:
            raise RuntimeError("the pools a captured step writes were replaced; a graph "
                               "holds their addresses, so they must be written in place")
        if self.graph is None:
            self._capture(pools)
        self.graph.replay()
        self.counts.add()
        return self.logits

    def _capture(self, pools: list[dict]) -> None:
        t0 = time.perf_counter()
        bt, slot_ids, pos, ctx, tok = self.inputs
        idle = (torch.full_like(bt, -1), torch.zeros_like(slot_ids), torch.full_like(pos, -1),
                torch.zeros_like(ctx), torch.zeros_like(tok))
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with StepCounts().record(), torch.cuda.stream(self.stream):
            self.fn(self.params, pools, *idle)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with self.counts.record(), torch.cuda.graph(graph, stream=self.stream):
            out_pools, self.logits = self.fn(self.params, pools, *self.inputs)
        if pool_ptrs(out_pools) != self.ptrs:
            raise RuntimeError("the captured step returned other pool tensors than it was given")
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
