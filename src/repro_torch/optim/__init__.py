"""repro_torch.optim — the optimizers and LR schedules, the port of
``repro.optim`` (the reference's arithmetic, not ``torch.optim``'s).
"""
from .optimizers import (
    Optimizer,
    OptState,
    adafactor,
    adamw,
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    sgd,
)
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Optimizer", "OptState", "adafactor", "adamw", "clip_by_global_norm",
    "get_optimizer", "global_norm", "sgd", "constant", "cosine_decay",
    "linear_warmup_cosine",
]
