"""The paper's own benchmark models (Table 1) — 10 RNN apps, 20 layers.

Dims are exactly Table 1's. A copy of ``repro.configs.paper_models``,
which has no JAX code. ``nonstructured_pr`` is the paper-reported
non-structured pruning rate (the theoretical optimum CSB approaches).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RNNLayerCfg:
    idx: int
    cell: str           # lstm | gru | lstmp | ligru
    n_input: int
    n_hidden: int
    proj: int | None = None


@dataclasses.dataclass(frozen=True)
class PaperModel:
    abbr: str
    app: str
    dataset: str
    metric: str
    higher_is_better: bool
    layers: tuple[RNNLayerCfg, ...]
    nonstructured_pr: float   # paper Table 1 (x compression)


PAPER_MODELS: dict[str, PaperModel] = {
    "MT1": PaperModel(
        "MT1", "Machine Translation", "PTB", "PPL", False,
        (RNNLayerCfg(1, "lstm", 128, 256), RNNLayerCfg(2, "lstm", 256, 256)),
        13.2),
    "MT2": PaperModel(
        "MT2", "Machine Translation", "PTB", "PPL", False,
        (RNNLayerCfg(3, "lstm", 1500, 1500),
         RNNLayerCfg(4, "lstm", 1500, 1500)),
        16.3),
    "SR1": PaperModel(
        "SR1", "Speech Recognition", "TIMIT", "PER", False,
        (RNNLayerCfg(5, "lstmp", 153, 1024, proj=512),
         RNNLayerCfg(6, "lstmp", 512, 1024, proj=512)),
        14.5),
    "SR2": PaperModel(
        "SR2", "Speech Recognition", "TIMIT", "PER", False,
        (RNNLayerCfg(7, "gru", 39, 1024), RNNLayerCfg(8, "gru", 1024, 1024)),
        21.7),
    "SR3": PaperModel(
        "SR3", "Speech Recognition", "TIMIT", "PER", False,
        (RNNLayerCfg(9, "ligru", 39, 512), RNNLayerCfg(10, "ligru", 512, 512)),
        7.1),
    "SR4": PaperModel(
        "SR4", "Speech Recognition", "TDIGIT", "Accuracy", True,
        (RNNLayerCfg(11, "gru", 39, 256),),
        25.7),
    "SPP": PaperModel(
        "SPP", "Stock Price Prediction", "S&P500", "NPD", False,
        (RNNLayerCfg(12, "lstm", 1, 128), RNNLayerCfg(13, "lstm", 128, 128)),
        4.1),
    "SC1": PaperModel(
        "SC1", "Sentiment Classification", "IMDB", "Accuracy", True,
        (RNNLayerCfg(14, "lstm", 32, 512), RNNLayerCfg(15, "lstm", 512, 512),
         RNNLayerCfg(16, "lstm", 512, 512)),
        10.4),
    "SC2": PaperModel(
        "SC2", "Sentiment Classification", "MR", "Accuracy", True,
        (RNNLayerCfg(17, "lstm", 50, 256),),
        7.2),
    "QA": PaperModel(
        "QA", "Question Answering", "BABI", "Accuracy", True,
        (RNNLayerCfg(18, "lstm", 50, 256), RNNLayerCfg(19, "lstm", 256, 256),
         RNNLayerCfg(20, "lstm", 256, 256)),
        7.9),
}
