"""repro_torch.configs — the assigned architectures and the paper's
Table-1 models."""
from .paper_models import PAPER_MODELS, PaperModel, RNNLayerCfg
from .registry import (
    ARCH_IDS, all_cells, cell_is_runnable, get_config, get_reduced,
    shape_overrides, sharding_policy, train_microbatches,
)

__all__ = ["ARCH_IDS", "PAPER_MODELS", "PaperModel", "RNNLayerCfg",
           "all_cells", "cell_is_runnable", "get_config", "get_reduced",
           "shape_overrides", "sharding_policy", "train_microbatches"]
