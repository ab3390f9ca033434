"""Training loop (port of ``repro/train``): loss, train step with gradient
accumulation, the Trainer with checkpoint/resume and the step monitor."""

from repro_torch.train.trainer import (TrainConfig, Trainer, loss_fn, make_eval_step,
                                       make_train_step)

__all__ = ["TrainConfig", "Trainer", "make_eval_step", "make_train_step", "loss_fn"]
