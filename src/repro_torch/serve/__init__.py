"""repro_torch.serve — frame-by-frame RNN serving, batched generation and
continuous batching for decoder LMs (contiguous or paged, with prefix
sharing and speculative decoding), and their configuration."""
from .config import EngineConfig, resolve_config
from .engine import (
    ServeResult, bucket_len, generate, rnn_serve_frames, serve_continuous,
)
from .paging import PagePool, pages_for
from .scheduler import Request, SlotScheduler, simulate_admission
from .speculative import derive_draft_params

__all__ = ["EngineConfig", "PagePool", "Request", "ServeResult",
           "SlotScheduler", "bucket_len", "derive_draft_params", "generate",
           "pages_for", "resolve_config", "rnn_serve_frames",
           "serve_continuous", "simulate_admission"]
