"""Atomic, integrity-checked, resumable checkpoints (port of ``repro/checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (CheckpointManager, load_checkpoint,
                                                 save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]
