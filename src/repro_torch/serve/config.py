"""One serving configuration object for every engine entry point.

A copy of ``repro.serve.config``, which has no JAX code: the same
frozen, validated :class:`EngineConfig`, so a configuration means the
same thing in both packages. The port's engine consumes it in
``rnn_serve_frames`` (``frame_warmup``, ``collect_frame_times``); the
LM-serving fields wait for the port of the LM serve stack and are kept
so that the validation rules stay identical.

Cross-field constraints live in ``__post_init__`` so an invalid
combination fails at construction: ``use_kernel``/``prefix_cache``/
``pool_pages`` all require ``paged``, and the speculative knobs require
``speculative``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["EngineConfig", "resolve_config"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Unified serving configuration (see module docstring).

    Generation:
      ``max_new_tokens`` — tokens to generate per request/batch row.
      ``temperature``    — 0 => greedy (the parity-testable path).
      ``cache_len``      — decode cache time capacity; default fits
                           prompt + new tokens.

    Continuous batching:
      ``n_slots``        — fixed decode batch width.

    Paged cache (``paged=True``):
      ``page_size``      — tokens per physical page.
      ``pool_pages``     — pool capacity in pages (default: the full
                           contiguous footprint ``n_slots * max_pages``).
      ``prefix_cache``   — refcounted radix-trie prompt sharing + CoW.
      ``use_kernel``     — the paged-attention decode kernel.

    Speculative decoding (``speculative=True``):
      ``spec_k``           — draft tokens proposed per verify round.
      ``draft_prune_rate`` — CSB pruning rate for the self-drafted
                             model (0.0 => draft == target, the parity
                             configuration).

    Prefill:
      ``bucket_prompts`` — pow2 prompt buckets (None: on when paged,
                           auto-off for SSD/hybrid mixers).

    Frame serving (``rnn_serve_frames``):
      ``frame_warmup``         — compile/warmup steps before timing.
      ``collect_frame_times``  — per-frame blocking latency pass.
    """

    # generation
    max_new_tokens: int = 32
    temperature: float = 0.0
    cache_len: int | None = None
    # continuous batching
    n_slots: int = 4
    # paged cache
    paged: bool = False
    page_size: int = 16
    pool_pages: int | None = None
    prefix_cache: bool = False
    use_kernel: bool = False
    # speculative decoding
    speculative: bool = False
    spec_k: int = 4
    draft_prune_rate: float = 0.5
    # prefill
    bucket_prompts: bool | None = None
    # frame serving
    frame_warmup: int = 2
    collect_frame_times: bool = False

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if self.cache_len is not None and self.cache_len < 1:
            raise ValueError("cache_len must be >= 1 (or None)")
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.frame_warmup < 0:
            raise ValueError("frame_warmup must be >= 0")
        if not self.paged:
            # every paged-only knob must fail loudly instead of being
            # silently ignored by the contiguous engine
            for knob in ("use_kernel", "prefix_cache"):
                if getattr(self, knob):
                    raise ValueError(f"{knob}=True requires paged=True")
            if self.pool_pages is not None:
                raise ValueError("pool_pages requires paged=True")
        if self.pool_pages is not None and self.pool_pages < 1:
            raise ValueError("pool_pages must be >= 1 (or None)")
        if self.spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if not 0.0 <= self.draft_prune_rate < 1.0:
            raise ValueError("draft_prune_rate must be in [0, 1)")
        if self.speculative and self.prefix_cache:
            raise ValueError(
                "speculative=True does not support prefix_cache=True "
                "(the draft has no shared-page partial prefill)")

    def replace(self, **updates) -> "EngineConfig":
        """A modified copy (re-validated)."""
        return dataclasses.replace(self, **updates)


def resolve_config(config: EngineConfig | None, *,
                   caller: str) -> EngineConfig:
    """Normalize the ``config=`` argument: ``None`` means defaults, and
    anything that is not an :class:`EngineConfig` raises ``TypeError``
    naming the caller (the loose-kwargs shim that used to live here was
    removed after its one-release deprecation window)."""
    if config is None:
        return EngineConfig()
    if not isinstance(config, EngineConfig):
        raise TypeError(
            f"{caller}() expects config=EngineConfig(...), got "
            f"{type(config).__name__}")
    return config
