"""repro_torch.train — the training loop and checkpoints, the port of
``repro.train``.

``loop``       — ``TrainConfig``, ``make_train_step`` (autograd,
                 microbatches, int8 error-feedback compression, clipping,
                 the ADMM penalty), ``StepTimer`` and ``train`` (auto-resume,
                 periodic checkpoints, ADMM updates, telemetry).
``checkpoint`` — the JAX package's on-disk layout and leaf order, so a
                 checkpoint restores in either package.
"""
from . import checkpoint
from .loop import StepTimer, TrainConfig, make_train_step, train

__all__ = ["StepTimer", "TrainConfig", "checkpoint", "make_train_step",
           "train"]
