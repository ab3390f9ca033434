"""Paged continuous-batching serving of the port (``repro.serving``'s public
API): the int4 K-Means paged KV cache, the scheduler, speculative decoding
and telemetry."""

from repro_torch.serving.engine import (ServeConfig, ServingEngine, make_prefill_step,
                                        make_serve_step)
from repro_torch.serving.paged_cache import BlockAllocator, PagedCacheConfig
from repro_torch.serving.scheduler import Request, RequestState, Scheduler
from repro_torch.serving.speculative import (DEFAULT_DRAFT_SPEC, DraftRunner, SpeculativeConfig,
                                             greedy_verify)
from repro_torch.serving.telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                                           NullTelemetry, StreamingStats, Telemetry,
                                           TelemetryConfig, linear_buckets, log_buckets,
                                           make_telemetry)

__all__ = [
    "ServeConfig", "ServingEngine", "make_prefill_step", "make_serve_step", "BlockAllocator",
    "PagedCacheConfig", "Request", "RequestState", "Scheduler", "SpeculativeConfig",
    "DraftRunner", "greedy_verify", "DEFAULT_DRAFT_SPEC", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "StreamingStats", "Telemetry", "TelemetryConfig", "NullTelemetry",
    "make_telemetry", "log_buckets", "linear_buckets",
]
