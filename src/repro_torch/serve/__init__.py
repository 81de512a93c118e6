"""repro_torch.serve — frame-by-frame RNN serving, paged continuous
batching for decoder LMs, and their configuration."""
from .config import EngineConfig, resolve_config
from .engine import ServeResult, bucket_len, rnn_serve_frames, serve_continuous
from .paging import PagePool, pages_for
from .scheduler import Request, SlotScheduler, simulate_admission

__all__ = ["EngineConfig", "PagePool", "Request", "ServeResult",
           "SlotScheduler", "bucket_len", "pages_for", "resolve_config",
           "rnn_serve_frames", "serve_continuous", "simulate_admission"]
