"""Serving telemetry (port of ``repro/serving/telemetry.py``): typed
metrics, request lifecycle timelines, step records and their exporters.

One :class:`Telemetry` object per engine owns four things:

1. a **typed metrics registry** -- :class:`Counter`, :class:`Gauge` (settable
   or callback-backed) and fixed-bucket :class:`Histogram` (log- or
   linear-spaced). The scheduler's counters are registry counters, and
   ``Scheduler.stats`` / ``ServingEngine.stats`` rebuild their dicts from it.
2. a **per-request lifecycle timeline** -- enqueue, admit (with prefix-hit
   size), prefill chunks, first token, verify rounds, preempt, finish, with
   wall times, so TTFT, inter-token latency, queue wait and end-to-end
   latency percentiles come from the engine itself. The histograms update
   at the default ``metrics`` level; per-request event lists are kept only
   under ``trace``.
3. a **bounded ring buffer of per-packed-step records** -- budget
   utilization, rows by kind, blocks allocated / freed / copied, the
   host-prep vs device time split and the step's host phases. Without
   ``fence`` device time is the wall time of the step's dispatch (a graph
   replay returns at once, so it holds little of the device's work) and
   the sampling copy's wait for the replay lands in host time;
   ``fence=True`` synchronizes on the logits' stream, so the split is
   exact, and marks the regions of the captured packed step (below).
4. **exporters** -- :meth:`Telemetry.snapshot` (a JSON-able dict of every
   metric plus derived percentiles), :meth:`Telemetry.export_chrome_trace`
   (Chrome / Perfetto trace-event JSON: packed steps and draft dispatches on
   an engine lane, one lane per request, numerics counter tracks on pid 2;
   load it at ``ui.perfetto.dev``) and :meth:`Telemetry.expfmt` (Prometheus
   text).

**Host phases.** Each step record's ``phases`` lists ``(name, t0_ns,
t1_ns)`` of ``Scheduler.step``'s host phases in order -- ``admit`` (admission
and finishing), ``plan`` (growth and copy-on-write), ``pack`` (the host
arrays), ``replay`` (the upload and the replay, and the wait under
``fence``), ``sample`` (the draw and its copy to the host), ``commit``
(bookkeeping up to the record; a draft's proposal, under speculation,
lies between ``plan`` and ``pack``, in no phase) -- stamped with
``time.time_ns``, the clock ``torch.profiler`` stamps its events with on
Linux, so a profiler trace's device idle can be attributed to them. ``host_s`` and ``device_s`` keep
their own ``perf_counter`` arithmetic; ``host_s`` starts at ``plan``.

**Regions.** Model code marks flat, non-nested region boundaries with
:func:`region`: ``qlinear.main``, ``qlinear.detect``, ``qlinear.residual``,
``qlinear.comp_dequant``, ``qlinear.comp_matmul``, ``attn.core``,
``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``head``
and ``other`` (norms, residual adds, the embedding). When the packed step
is captured under ``fence=True`` on CUDA, each boundary records a marker
kernel into the graph (:class:`RegionMarks`), and every record of a replay
carries the regions' names in marker order as ``region_marks``: in a
profiler trace of the replay, the ops between the k-th marker and the next
are the k-th region's, so a fenced step's record, with a profiler trace,
is exact about where the device time went. Everywhere else -- without
``fence``, eagerly, on the CPU, in the capture's warm-up run -- a boundary
is a Python no-op that issues no aten op, records nothing and reads no
clock, and the unfenced graph is the one captured without boundaries. The
exporters leave ``phases`` and ``region_marks`` out.

Levels (``ServeConfig.telemetry``): ``"off"`` is a null object -- every method
is a no-op, with no clock read and no profiler range. ``"metrics"`` (the
default) keeps counters, gauges, histograms and the step ring. ``"trace"``
adds per-request event timelines and named spans. ``"quality"`` is trace plus
the quantization-numerics probes of ``core/numerics``: 1 in
``quality_sample_every`` packed steps runs the probed step, a second
captured graph on the card. The spans (``torch.profiler.record_function``)
never wrap captured code, only graph replays and eager dispatches, and the
region boundaries issue no aten op, so the packed step runs the same aten
ops at off, metrics and trace, fenced or not.

:class:`StreamingStats` is the one windowed streaming-stats implementation:
the step records use it, and
``repro_torch.distributed.fault_tolerance.StepMonitor`` wraps it.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import dataclasses
import json
import math
import pathlib
import re
import time
from collections import deque

import torch

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StreamingStats",
    "TelemetryConfig", "Telemetry", "NullTelemetry", "make_telemetry",
    "log_buckets", "linear_buckets", "region", "RegionMarks",
]


# ---------------------------------------------------------------------------
# bucket helpers
# ---------------------------------------------------------------------------

def log_buckets(lo: float, hi: float, per_decade: int = 6) -> list[float]:
    """Geometric bucket upper bounds covering [lo, hi]."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = max(1, round(per_decade * math.log10(hi / lo)))
    ratio = (hi / lo) ** (1.0 / n)
    return [lo * ratio**i for i in range(n + 1)]


def linear_buckets(lo: float, hi: float, n: int) -> list[float]:
    """n equal-width bucket upper bounds over [lo, hi]."""
    if n < 1 or hi <= lo:
        raise ValueError(f"need n >= 1 and hi > lo, got n={n}, ({lo}, {hi})")
    w = (hi - lo) / n
    return [lo + w * (i + 1) for i in range(n)]


# ---------------------------------------------------------------------------
# metric types
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter (floats allowed: time totals are counters too)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value: ``set``, ``set_max`` (high-water mark), or a
    zero-arg callback evaluated lazily at snapshot time (allocator state)."""

    __slots__ = ("name", "help", "fn", "_value")

    def __init__(self, name: str, help: str = "", fn=None):
        self.name, self.help, self.fn = name, help, fn
        self._value = 0.0

    @property
    def value(self):
        return self.fn() if self.fn is not None else self._value

    def set(self, v) -> None:
        self._value = v

    def set_max(self, v) -> None:
        if v > self._value:
            self._value = v

    def reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are ascending upper bounds, with an
    implicit +inf overflow bucket. Percentiles are interpolated inside the
    landing bucket (exact per-sample values are never stored — observation is
    O(log buckets) and allocation-free)."""

    __slots__ = ("name", "help", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, bounds: list[float], help: str = ""):
        if list(bounds) != sorted(bounds) or len(bounds) < 1:
            raise ValueError(f"histogram {name}: bounds must be ascending")
        self.name, self.help = name, help
        self.bounds = [float(b) for b in bounds]
        self.reset()

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear interpolation
        within the landing bucket, clamped to the observed min/max."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if acc + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(self.min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                frac = (target - acc) / c
                v = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.min, min(self.max, v))
            acc += c
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class _NullMetric:
    """Shared no-op stand-in for off-level counters/gauges/histograms."""

    name = "null"
    value = 0
    count = 0
    sum = 0.0

    def add(self, n=1):
        pass

    def set(self, v):
        pass

    def set_max(self, v):
        pass

    def observe(self, v):
        pass

    def reset(self):
        pass

    def percentile(self, q):
        return 0.0

    def summary(self):
        return {"count": 0}


_NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Name -> metric table; get-or-create, so instrumentation sites never
    race over who registers first (names are global per engine)."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name, help, fn=fn)
        elif fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, bounds: list[float] | None = None,
                  help: str = "") -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(
                name, bounds if bounds is not None else log_buckets(1e-5, 100.0),
                help)
        return h

    def reset(self) -> None:
        for m in (*self.counters.values(), *self.gauges.values(),
                  *self.histograms.values()):
            m.reset()

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }


# ---------------------------------------------------------------------------
# streaming stats (shared with distributed.fault_tolerance.StepMonitor)
# ---------------------------------------------------------------------------

class StreamingStats:
    """Windowed streaming statistics over a scalar series (step times).

    THE streaming-stats implementation: telemetry's step records use it for
    running medians, and ``fault_tolerance.StepMonitor`` layers straggler
    detection on top rather than keeping a parallel copy."""

    def __init__(self, window: int = 64):
        self.window = window
        self._vals: deque[float] = deque(maxlen=window)

    def record(self, v: float) -> None:
        self._vals.append(v)

    @property
    def times(self) -> list[float]:
        return list(self._vals)

    def __len__(self) -> int:
        return len(self._vals)

    def mean(self) -> float:
        return sum(self._vals) / len(self._vals) if self._vals else 0.0

    def percentile(self, q: float) -> float:
        if not self._vals:
            return 0.0
        s = sorted(self._vals)
        return s[min(len(s) - 1, int(q / 100.0 * (len(s) - 1) + 0.5))]

    def median(self) -> float:
        if not self._vals:
            return 0.0
        s = sorted(self._vals)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def summary(self) -> dict:
        if not self._vals:
            return {}
        return {"median_s": self.median(), "p95_s": self.percentile(95),
                "mean_s": self.mean(), "n": len(self._vals)}


# ---------------------------------------------------------------------------
# regions inside a captured step
# ---------------------------------------------------------------------------

_REGIONS: contextvars.ContextVar["RegionMarks | None"] = contextvars.ContextVar(
    "repro_torch_regions", default=None)


def region(name: str) -> None:
    """A region boundary: the device ops launched from here to the next
    boundary belong to ``name``. Acts only while a :class:`RegionMarks`
    records a capture; otherwise it does nothing."""
    recorder = _REGIONS.get()
    if recorder is not None:
        recorder.mark(name)


class RegionMarks:
    """The region boundaries of one captured step. Each boundary records a
    marker kernel into the graph (a one-cycle ``torch.cuda._sleep``, which
    ``torch.profiler`` names after its ``spin_kernel``) and appends the
    region's name to ``names``: in a profiled replay the device ops between
    the k-th marker and the next belong to ``names[k]``, by device order
    alone. The step's first op is a marker (``other``) and so is its last."""

    def __init__(self):
        self.names: tuple[str, ...] = ()
        self._names: list[str] = []

    def mark(self, name: str) -> None:
        torch.cuda._sleep(1)
        self._names.append(name)

    @contextlib.contextmanager
    def recording(self):
        """Record the body's boundaries (call it inside the capture)."""
        self._names = []
        self.mark("other")
        token = _REGIONS.set(self)
        try:
            yield self
        finally:
            _REGIONS.reset(token)
            self.mark("other")
            self.names = tuple(self._names)


# ---------------------------------------------------------------------------
# telemetry object
# ---------------------------------------------------------------------------

_LEVELS = ("off", "metrics", "trace", "quality")


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """``ServeConfig.telemetry``. ``level``: ``"off"`` (null object),
    ``"metrics"`` (default: counters/gauges/histograms + step ring),
    ``"trace"`` (adds per-request event timelines + named spans for the
    Perfetto export), or ``"quality"`` (trace + the quantization-numerics
    probes of ``core/numerics``, which add a second captured step).
    ``fence=True`` blocks on the packed step's output so the host/device
    time split is exact (adds a sync, never a dispatch), and on CUDA
    captures the packed step with a marker kernel at each region boundary,
    whose regions each step record carries as ``region_marks``: a fenced
    step's record is exact about where the device time went, given a
    profiler trace of the replay (see the module docstring). Without it
    the captured graph holds no marker. ``step_ring``
    bounds the per-step record buffer; ``max_requests`` bounds completed
    request timelines kept under trace.

    Quality knobs (ignored below level quality): ``quality_sample_every``
    probes 1 in N packed steps (step 0 always probes, so short smokes
    populate every gauge); ``quality_shadow_every`` runs the shadow-
    reference forward every N packed steps; ``quality_drift_threshold`` is
    the absolute per-site drift score that raises ``numerics_drift_alarms``.
    """

    level: str = "metrics"
    fence: bool = False
    step_ring: int = 512
    max_requests: int = 2048
    quality_sample_every: int = 16
    quality_shadow_every: int = 32
    quality_drift_threshold: float = 0.5

    def __post_init__(self):
        if self.level not in _LEVELS:
            raise ValueError(
                f"telemetry level must be one of {_LEVELS}, got {self.level!r}")
        if self.step_ring < 1 or self.max_requests < 1:
            raise ValueError("step_ring and max_requests must be >= 1")
        if self.quality_sample_every < 1 or self.quality_shadow_every < 1:
            raise ValueError(
                "quality_sample_every and quality_shadow_every must be >= 1")
        if self.quality_drift_threshold <= 0:
            raise ValueError("quality_drift_threshold must be > 0")

    @classmethod
    def parse(cls, v) -> "TelemetryConfig":
        """Coerce ServeConfig.telemetry: a config, a level string, a bool
        (True -> metrics, False -> off), or None -> off."""
        if isinstance(v, cls):
            return v
        if v is None or v is False:
            return cls(level="off")
        if v is True:
            return cls(level="metrics")
        if isinstance(v, str):
            if v == "trace":
                return cls(level="trace")
            return cls(level=v)
        raise TypeError(f"cannot parse telemetry config from {v!r}")


@dataclasses.dataclass
class _RequestTrace:
    rid: int
    t_enqueue: float
    n_prompt: int = 0
    t_admit: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None
    t_last_token: float | None = None
    prefix_hit_tokens: int = 0
    n_generated: int = 0
    preemptions: int = 0
    events: list | None = None  # [(t, name, args)] under trace level


class Telemetry:
    """Live telemetry for one serving engine (see module docstring)."""

    def __init__(self, cfg: TelemetryConfig | None = None, clock=time.perf_counter,
                 phase_clock=time.time_ns):
        self.cfg = cfg or TelemetryConfig()
        if self.cfg.level == "off":
            raise ValueError("level=off is NullTelemetry; use make_telemetry()")
        self._clock = clock
        self._phase_clock = phase_clock
        self.registry = MetricsRegistry()
        self.step_times = StreamingStats(window=min(self.cfg.step_ring, 256))
        self._t0 = clock()
        self.steps: deque[dict] = deque(maxlen=self.cfg.step_ring)
        self.spans: deque[tuple] = deque(maxlen=4 * self.cfg.step_ring)
        self._live: dict[int, _RequestTrace] = {}
        self.completed: deque[_RequestTrace] = deque(maxlen=self.cfg.max_requests)
        # (t, name, value) samples for Perfetto counter tracks (quality level)
        self.quality_series: deque[tuple] = deque(maxlen=8 * self.cfg.step_ring)
        self._mk_serving_metrics()

    # -------------------------------------------------------------- plumbing
    @property
    def enabled(self) -> bool:
        return True

    @property
    def tracing(self) -> bool:
        return self.cfg.level in ("trace", "quality")

    @property
    def quality(self) -> bool:
        return self.cfg.level == "quality"

    @property
    def fence(self) -> bool:
        return self.cfg.fence

    def now(self) -> float:
        return self._clock()

    def stamp(self) -> int:
        """A host-phase boundary in ns on the profiler's clock."""
        return self._phase_clock()

    def counter(self, name: str, help: str = "") -> Counter:
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        return self.registry.gauge(name, help, fn=fn)

    def histogram(self, name: str, bounds=None, help: str = "") -> Histogram:
        return self.registry.histogram(name, bounds, help)

    def annotate(self, name: str):
        """A ``torch.profiler.record_function`` range (so profiler traces
        carry the timeline's names) that also lands in the span deque under
        trace and quality. Wraps a dispatch or a graph replay, never captured
        code."""
        ann = torch.profiler.record_function(name)
        if not self.tracing:
            return ann
        return _Span(self, name, ann)

    def reset(self) -> None:
        """Zero every metric and drop buffered timelines (benchmarks call
        this after jit warmup so measurements start clean)."""
        self.registry.reset()
        self.steps.clear()
        self.spans.clear()
        self._live.clear()
        self.completed.clear()
        self.quality_series.clear()
        self.step_times = StreamingStats(window=self.step_times.window)
        self._t0 = self._clock()

    def quality_counter(self, name: str, value: float) -> None:
        """Record one sample of a quality counter track (rendered as a
        Perfetto "C" event on pid 2, sharing the timeline with the latency
        lanes). Bounded deque; call per probed step, not per site."""
        self.quality_series.append((self.now(), name, float(value)))

    def _mk_serving_metrics(self) -> None:
        """Pre-register the serving metric families so a snapshot taken
        before traffic still shows the full (zeroed) schema."""
        self.hist_ttft = self.histogram(
            "serving_ttft_s", log_buckets(1e-4, 1e3),
            "enqueue -> first sampled token, seconds")
        self.hist_itl = self.histogram(
            "serving_itl_s", log_buckets(1e-5, 1e2),
            "inter-token latency per committed decode token, seconds")
        self.hist_e2e = self.histogram(
            "serving_e2e_s", log_buckets(1e-4, 1e3),
            "enqueue -> finish, seconds")
        self.hist_queue = self.histogram(
            "serving_queue_wait_s", log_buckets(1e-5, 1e3),
            "enqueue -> admission, seconds")
        self.hist_step_host = self.histogram(
            "serving_step_host_s", log_buckets(1e-6, 1e2),
            "host-side packed-step prep per step, seconds")
        self.hist_step_device = self.histogram(
            "serving_step_device_s", log_buckets(1e-6, 1e2),
            "packed-step dispatch (device when fenced) per step, seconds")
        self.hist_step_util = self.histogram(
            "serving_step_util", linear_buckets(0.0, 1.0, 20),
            "valid cells / token budget per packed step")

    # ------------------------------------------------------ request lifecycle
    def _trace(self, rid: int) -> _RequestTrace | None:
        return self._live.get(rid)

    def request_submitted(self, rid: int, n_prompt: int) -> None:
        t = self.now()
        self.counter("serving_requests_submitted").add()
        tr = _RequestTrace(rid=rid, t_enqueue=t, n_prompt=n_prompt)
        if self.tracing:
            tr.events = [(t, "enqueue", {"prompt_tokens": n_prompt})]
        self._live[rid] = tr

    def request_admitted(self, rid: int, prefix_hit_tokens: int = 0) -> None:
        t = self.now()
        self.counter("serving_requests_admitted").add()
        tr = self._trace(rid)
        if tr is None:
            return
        if tr.t_admit is None:  # re-admission after preemption keeps the first
            tr.t_admit = t
            self.hist_queue.observe(t - tr.t_enqueue)
        tr.prefix_hit_tokens += prefix_hit_tokens
        if tr.events is not None:
            tr.events.append((t, "admit", {"prefix_hit_tokens": prefix_hit_tokens}))

    def request_event(self, rid: int, name: str, **args) -> None:
        """Trace-level timeline event (prefill_chunk, verify_round, rollback,
        cow, ...); a no-op at the metrics level."""
        if not self.tracing:
            return
        tr = self._trace(rid)
        if tr is not None and tr.events is not None:
            tr.events.append((self.now(), name, args))

    def first_token(self, rid: int) -> None:
        t = self.now()
        tr = self._trace(rid)
        if tr is None:
            return
        if tr.t_first_token is None:
            tr.t_first_token = tr.t_last_token = t
            self.hist_ttft.observe(t - tr.t_enqueue)
            if tr.events is not None:
                tr.events.append((t, "first_token", {}))
        tr.n_generated += 1

    def tokens_committed(self, rid: int, n: int) -> None:
        """n decode tokens committed for rid this step (n > 1 under
        speculation). ITL credits each token dt/n — the tokens became
        available simultaneously, so the per-token latency is the round
        time amortized over what it committed."""
        if n <= 0:
            return
        t = self.now()
        tr = self._trace(rid)
        if tr is None:
            return
        tr.n_generated += n
        if tr.t_last_token is not None:
            dt = (t - tr.t_last_token) / n
            for _ in range(n):
                self.hist_itl.observe(dt)
        tr.t_last_token = t

    def request_preempted(self, rid: int) -> None:
        self.counter("serving_preemptions").add()
        tr = self._trace(rid)
        if tr is None:
            return
        tr.preemptions += 1
        if tr.events is not None:
            tr.events.append((self.now(), "preempt", {}))

    def request_finished(self, rid: int, n_generated: int | None = None) -> None:
        t = self.now()
        self.counter("serving_requests_finished").add()
        tr = self._live.pop(rid, None)
        if tr is None:
            return
        tr.t_finish = t
        if n_generated is not None:  # authoritative count from the scheduler
            tr.n_generated = n_generated
        self.hist_e2e.observe(t - tr.t_enqueue)
        if tr.events is not None:
            tr.events.append((t, "finish", {"generated": tr.n_generated}))
        if self.tracing:
            self.completed.append(tr)

    # ------------------------------------------------------------ step records
    def step_record(self, *, host_s: float, device_s: float, cells: int,
                    budget: int, decode_rows: int = 0, verify_rows: int = 0,
                    prefill_rows: int = 0, blocks_allocated: int = 0,
                    blocks_freed: int = 0, blocks_copied: int = 0,
                    phases: list | None = None,
                    region_marks: tuple | None = None) -> None:
        """One packed step's accounting -> histograms + the bounded ring.
        ``phases`` ([(name, t0_ns, t1_ns)]) and ``region_marks`` (region
        names in marker order) go into the record only when given."""
        util = cells / budget if budget else 0.0
        self.hist_step_host.observe(host_s)
        self.hist_step_device.observe(device_s)
        self.hist_step_util.observe(util)
        self.step_times.record(host_s + device_s)
        rec = {
            "t": self.now() - self._t0,
            "host_s": host_s, "device_s": device_s,
            "cells": cells, "budget": budget, "util": util,
            "decode_rows": decode_rows, "verify_rows": verify_rows,
            "prefill_rows": prefill_rows,
            "blocks_allocated": blocks_allocated,
            "blocks_freed": blocks_freed, "blocks_copied": blocks_copied,
        }
        for key, v in (("phases", phases), ("region_marks", region_marks)):
            if v is not None:
                rec[key] = v
        self.steps.append(rec)

    # -------------------------------------------------------------- exporters
    def snapshot(self) -> dict:
        """JSON-able dump of every metric plus derived latency percentiles."""
        snap = self.registry.snapshot()
        snap["level"] = self.cfg.level
        snap["requests"] = {
            "live": len(self._live),
            "completed_traced": len(self.completed),
            "ttft_s": self.hist_ttft.summary(),
            "itl_s": self.hist_itl.summary(),
            "e2e_s": self.hist_e2e.summary(),
            "queue_wait_s": self.hist_queue.summary(),
        }
        snap["steps"] = {
            "recorded": len(self.steps),
            "step_time": self.step_times.summary(),
            "host_s": self.hist_step_host.summary(),
            "device_s": self.hist_step_device.summary(),
            "util": self.hist_step_util.summary(),
        }
        return snap

    def export_chrome_trace(self, path: str | pathlib.Path) -> pathlib.Path:
        """Write a Chrome/Perfetto trace-event JSON file and return its path.

        Lanes: pid 0 ("engine") carries packed-step slices (from the step
        ring) on tid 0 and named spans (draft scan/catch-up, trace level) on
        tid 1; pid 1 ("requests") gives every traced request its own tid with
        queued/prefill/decode phase slices and instant events; pid 2
        ("quality") renders the numerics counter tracks ("C" events — one
        track per metric, so quantization quality and latency share a
        timeline). Open the file at ui.perfetto.dev (or chrome://tracing)."""
        us = 1e6
        ev: list[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "packed_steps"}},
            {"ph": "M", "pid": 0, "tid": 1, "name": "thread_name",
             "args": {"name": "spans"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        if self.quality_series:
            ev.append({"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
                       "args": {"name": "quality"}})
            for t, name, v in self.quality_series:
                ev.append({"ph": "C", "pid": 2, "tid": 0, "name": name,
                           "ts": (t - self._t0) * us, "args": {"value": v}})
        for s in self.steps:
            dur = (s["host_s"] + s["device_s"]) * us
            t1 = s["t"] * us  # records stamp completion time
            ev.append({"ph": "X", "pid": 0, "tid": 0, "name": "packed_step",
                       "ts": t1 - dur, "dur": dur,
                       "args": {k: v for k, v in s.items() if k not in _UNEXPORTED}})
        for name, t_start, dur_s in self.spans:
            ev.append({"ph": "X", "pid": 0, "tid": 1, "name": name,
                       "ts": (t_start - self._t0) * us, "dur": dur_s * us})
        for tr in (*self.completed, *self._live.values()):
            tid = tr.rid
            ev.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                       "args": {"name": f"request {tr.rid}"}})

            def slice_(name, t0, t1, **args):
                if t0 is None or t1 is None or t1 < t0:
                    return
                ev.append({"ph": "X", "pid": 1, "tid": tid, "name": name,
                           "ts": (t0 - self._t0) * us,
                           "dur": (t1 - t0) * us, "args": args})

            slice_("queued", tr.t_enqueue, tr.t_admit,
                   prompt_tokens=tr.n_prompt)
            slice_("prefill", tr.t_admit, tr.t_first_token,
                   prefix_hit_tokens=tr.prefix_hit_tokens)
            slice_("decode", tr.t_first_token, tr.t_finish,
                   generated=tr.n_generated, preemptions=tr.preemptions)
            for t, name, args in tr.events or ():
                if name in ("enqueue", "admit", "first_token", "finish"):
                    continue  # already rendered as phase slices
                ev.append({"ph": "i", "pid": 1, "tid": tid, "name": name,
                           "ts": (t - self._t0) * us, "s": "t", "args": args})
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(
            {"traceEvents": ev, "displayTimeUnit": "ms",
             "otherData": {"level": self.cfg.level}}))
        return path

    def expfmt(self) -> str:
        """Prometheus text exposition of the registry (for external
        scrapers / file-based collection). Metric names are sanitized to the
        Prometheus charset (per-site gauges like ``numerics_sqnr_db.003.
        attn.q`` become ``numerics_sqnr_db_003_attn_q``); histograms emit
        the standard cumulative ``_bucket``/``_sum``/``_count`` triplet."""
        out: list[str] = []

        def emit(name, kind, help_, lines):
            if help_:
                out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {kind}")
            out.extend(lines)

        for k, c in sorted(self.registry.counters.items()):
            n = _promname(k)
            emit(n, "counter", c.help, [f"{n} {_promval(c.value)}"])
        for k, g in sorted(self.registry.gauges.items()):
            n = _promname(k)
            emit(n, "gauge", g.help, [f"{n} {_promval(g.value)}"])
        for k, h in sorted(self.registry.histograms.items()):
            n = _promname(k)
            lines, acc = [], 0
            for bound, cnt in zip(h.bounds, h.counts):
                acc += cnt
                lines.append(f'{n}_bucket{{le="{_promval(bound)}"}} {acc}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {_promval(h.sum)}")
            lines.append(f"{n}_count {h.count}")
            emit(n, "histogram", h.help, lines)
        return "\n".join(out) + ("\n" if out else "")


_UNEXPORTED = ("t", "phases", "region_marks")  # step-record keys


def _promname(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _promval(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Span:
    """Context manager pairing a profiler range with a span record."""

    __slots__ = ("tel", "name", "ann", "t0")

    def __init__(self, tel: Telemetry, name: str, ann):
        self.tel, self.name, self.ann = tel, name, ann

    def __enter__(self):
        self.ann.__enter__()
        self.t0 = self.tel.now()
        return self

    def __exit__(self, *exc):
        self.tel.spans.append((self.name, self.t0, self.tel.now() - self.t0))
        return self.ann.__exit__(*exc)


class NullTelemetry:
    """Level "off": every method is a no-op and every metric reads zero.
    No per-token allocation, no clock reads and no profiler ranges."""

    cfg = TelemetryConfig(level="off")
    enabled = False
    tracing = False
    quality = False
    fence = False
    steps: tuple = ()
    spans: tuple = ()
    completed: tuple = ()
    quality_series: tuple = ()

    def now(self) -> float:
        return 0.0

    def stamp(self) -> int:
        return 0

    def quality_counter(self, name, value):
        pass

    def expfmt(self) -> str:
        return ""

    def counter(self, name, help=""):
        return _NULL_METRIC

    def gauge(self, name, help="", fn=None):
        return _NULL_METRIC

    def histogram(self, name, bounds=None, help=""):
        return _NULL_METRIC

    def annotate(self, name):
        return contextlib.nullcontext()

    def reset(self):
        pass

    def request_submitted(self, rid, n_prompt):
        pass

    def request_admitted(self, rid, prefix_hit_tokens=0):
        pass

    def request_event(self, rid, name, **args):
        pass

    def first_token(self, rid):
        pass

    def tokens_committed(self, rid, n):
        pass

    def request_preempted(self, rid):
        pass

    def request_finished(self, rid, n_generated=None):
        pass

    def step_record(self, **kw):
        pass

    def snapshot(self) -> dict:
        return {"level": "off"}

    def export_chrome_trace(self, path):
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"traceEvents": [],
                                    "otherData": {"level": "off"}}))
        return path


NULL_TELEMETRY = NullTelemetry()


def make_telemetry(cfg, clock=time.perf_counter):
    """``ServeConfig.telemetry`` -> a live :class:`Telemetry` or the shared
    :class:`NullTelemetry` null object (accepts a config, level string, bool,
    or None; see :meth:`TelemetryConfig.parse`)."""
    cfg = TelemetryConfig.parse(cfg)
    if cfg.level == "off":
        return NULL_TELEMETRY
    return Telemetry(cfg, clock=clock)
