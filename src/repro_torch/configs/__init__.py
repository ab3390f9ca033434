"""Architecture configs ported so far (own copies of the JAX package's)."""

from repro_torch.configs.base import ModelConfig, get_config, get_smoke_config, list_archs

__all__ = ["ModelConfig", "get_config", "get_smoke_config", "list_archs"]
