"""Paged continuous-batching serving of the port (``repro.serving``'s public
API): the int4 K-Means paged KV cache, the scheduler, speculative decoding
and telemetry.

The telemetry loads here; the modules that reach the models load on first
use (PEP 562), since model code imports ``serving.telemetry`` for its
region boundaries and an eager import of them here would close a cycle."""

import importlib

from repro_torch.serving.telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                                           NullTelemetry, StreamingStats, Telemetry,
                                           TelemetryConfig, linear_buckets, log_buckets,
                                           make_telemetry)

_LAZY = {
    "ServeConfig": "engine", "ServingEngine": "engine", "make_prefill_step": "engine",
    "make_serve_step": "engine", "BlockAllocator": "paged_cache",
    "PagedCacheConfig": "paged_cache", "Request": "scheduler", "RequestState": "scheduler",
    "Scheduler": "scheduler", "DEFAULT_DRAFT_SPEC": "speculative",
    "DraftRunner": "speculative", "SpeculativeConfig": "speculative",
    "greedy_verify": "speculative",
}
_LAZY_MODULES = ("engine", "graph_step", "paged_cache", "scheduler", "speculative")

__all__ = [
    "ServeConfig", "ServingEngine", "make_prefill_step", "make_serve_step", "BlockAllocator",
    "PagedCacheConfig", "Request", "RequestState", "Scheduler", "SpeculativeConfig",
    "DraftRunner", "greedy_verify", "DEFAULT_DRAFT_SPEC", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "StreamingStats", "Telemetry", "TelemetryConfig", "NullTelemetry",
    "make_telemetry", "log_buckets", "linear_buckets",
]


def __getattr__(name):
    if name in _LAZY_MODULES:
        return importlib.import_module(f"repro_torch.serving.{name}")
    if name in _LAZY:
        return getattr(importlib.import_module(f"repro_torch.serving.{_LAZY[name]}"), name)
    raise AttributeError(f"module 'repro_torch.serving' has no attribute {name!r}")
