"""repro_torch.configs — the assigned architectures and the paper's
Table-1 models."""
from .paper_models import PAPER_MODELS, PaperModel, RNNLayerCfg
from .registry import (
    ARCH_IDS, cell_is_runnable, get_config, get_reduced, sharding_policy,
    train_microbatches,
)

__all__ = ["ARCH_IDS", "PAPER_MODELS", "PaperModel", "RNNLayerCfg",
           "cell_is_runnable", "get_config", "get_reduced",
           "sharding_policy", "train_microbatches"]
