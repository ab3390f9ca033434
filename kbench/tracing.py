"""Reads a ``torch.profiler`` trace of the window into plain numbers.

Device events are the kernels, copies and sets the profiler saw on the card
(user annotations left out). The traced window is the host span
``kbench.window``; within it the device is busy on the union of the device
events, and each idle gap is named by what the host was doing at its
middle: ``arrivals`` (submitting requests), ``sleep`` (waiting for the next
arrival), and inside ``kbench.step`` (one ``Scheduler.step``) ``pack``
(before the step's ``packed_step`` replay), ``replay`` (inside it) or
``sample`` (after it: sampling, the copy of the tokens to the host and the
scheduler's bookkeeping). The raw events are read directly: the profiler's
``key_averages`` builds a Python tree of every event first, which takes
minutes on a window of graph replays.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

__all__ = ["HAND_KERNELS", "Trace", "read"]

# the program's hand-written kernels, by a part of their device name
HAND_KERNELS = ("fused_lut_gemm_kernel", "lut_gemm_kernel", "bucketize_kernel",
                "topk_outlier_kernel", "streaming_kernel", "paged_attn::kernel")
HOST_SPANS = ("kbench.window", "kbench.step", "kbench.arrivals", "kbench.sleep", "packed_step")


class Trace:
    """``device``: [(name, start_ns, end_ns)] inside the window, in start
    order; ``window``: (start_ns, end_ns); ``busy_ns``; ``gaps``:
    {label: idle ns}."""

    def __init__(self, device, window, host):
        self.window = window
        w0, w1 = window
        self.device = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
        self.device.sort(key=lambda e: e[1])
        merged: list[list[int]] = []
        for _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_ns = sum(b - a for a, b in merged)
        self.gaps: dict[str, int] = defaultdict(int)
        idle = []
        t = w0
        for a, b in merged:
            if a > t:
                idle.append((t, a))
            t = max(t, b)
        if w1 > t:
            idle.append((t, w1))
        for a, b in idle:
            self.gaps[_label(host, (a + b) // 2)] += b - a

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def kernel_ns(self, part: str) -> tuple[int, int]:
        """(summed ns, launches) of the device events whose name has ``part``."""
        ev = [b - a for n, a, b in self.device if part in n]
        return sum(ev), len(ev)

    def total_ns(self) -> int:
        return sum(b - a for _, a, b in self.device)

    def hand_ns(self) -> int:
        return sum(b - a for n, a, b in self.device if any(k in n for k in HAND_KERNELS))

    def top_ops(self, n: int = 10) -> list[list]:
        sums: dict[str, int] = defaultdict(int)
        for name, a, b in self.device:
            sums[name[:160]] += b - a
        rows = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in rows]

    def top_gaps(self, n: int = 10) -> list[list]:
        rows = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in rows]


def _label(host: dict, t: int) -> str:
    """What the host was doing at time ``t``."""
    def inside(name):
        spans = host.get(name, [])
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return spans[i] if i >= 0 and spans[i][0] <= t < spans[i][1] else None

    for name, label in (("kbench.arrivals", "arrivals"), ("kbench.sleep", "sleep")):
        if inside(name):
            return label
    step = inside("kbench.step")
    if step is None:
        return "harness"
    replays = [s for s in host.get("packed_step", []) if step[0] <= s[0] < step[1]]
    if not replays:
        return "step.other"
    if t < replays[0][0]:
        return "step.pack"
    if t < replays[-1][1]:
        return "step.replay"
    return "step.sample"


def read(prof) -> Trace | None:
    """The window's trace from a finished profiler, or None when the
    profiler saw no device event (then nothing is reported from it)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                device.append((name, e.start_ns(), e.end_ns()))
        elif name in HOST_SPANS:
            host[name].append((e.start_ns(), e.end_ns()))
    for spans in host.values():
        spans.sort()
    if not device or not host.get("kbench.window"):
        return None
    return Trace(device, host["kbench.window"][0], dict(host))
