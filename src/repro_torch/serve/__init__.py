"""repro_torch.serve — frame-by-frame RNN serving and its configuration."""
from .config import EngineConfig, resolve_config
from .engine import rnn_serve_frames

__all__ = ["EngineConfig", "resolve_config", "rnn_serve_frames"]
