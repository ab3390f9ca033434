"""Straggler detection (port of the ``StepMonitor`` of
``repro/distributed/fault_tolerance.py``).

:class:`StepMonitor` keeps a running window of a scalar series (step times,
or the numerics layer's per-site drift scores) in the telemetry's
:class:`~repro_torch.serving.telemetry.StreamingStats` and flags a value
above ``straggler_factor`` times the running median. The rest of the JAX
module (elastic re-planning, heartbeats, resumable checkpoints) is not
ported.
"""

from __future__ import annotations

from repro_torch.serving.telemetry import StreamingStats

__all__ = ["StepMonitor", "StreamingStats"]


class StepMonitor:
    """Straggler detection (value > factor x running median, once the
    window holds 8 values) over a :class:`StreamingStats` window."""

    def __init__(self, window: int = 64, straggler_factor: float = 2.0):
        self.stats = StreamingStats(window=window)
        self.factor = straggler_factor
        self.straggler_count = 0

    @property
    def window(self) -> int:
        return self.stats.window

    @property
    def times(self) -> list[float]:
        return self.stats.times

    def record(self, dt: float) -> None:
        self.stats.record(dt)
        if self.is_straggler(dt):
            self.straggler_count += 1

    def median(self) -> float:
        return self.stats.median()

    def is_straggler(self, dt: float) -> bool:
        return len(self.stats) >= 8 and dt > self.factor * self.median()

    def summary(self) -> dict:
        if not len(self.stats):
            return {}
        return {
            "median_s": self.median(),
            "p95_s": self.stats.percentile(95),
            "stragglers": self.straggler_count,
        }
