"""Deterministic, resumable, host-sharded data pipeline (port of ``repro/data``)."""

from repro_torch.data.pipeline import ByteCorpus, DataConfig, TokenPipeline, synthetic_corpus

__all__ = ["ByteCorpus", "DataConfig", "TokenPipeline", "synthetic_corpus"]
