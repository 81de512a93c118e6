"""repro_torch.configs — the paper's Table-1 models."""
from .paper_models import PAPER_MODELS, PaperModel, RNNLayerCfg

__all__ = ["PAPER_MODELS", "PaperModel", "RNNLayerCfg"]
