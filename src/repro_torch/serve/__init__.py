"""repro_torch.serve — batched and continuous-batching inference loops,
ported from ``repro.serve``.

``config`` owns the :class:`EngineConfig` every entry point consumes;
``engine`` the loops (fixed-batch ``generate``, slot-based
``serve_continuous`` — contiguous or paged cache, pow2 prompt-bucketed
prefill, copy-on-write prefix sharing — and frame-by-frame
``rnn_serve_frames``); ``disagg`` splits the engine into a prefill tier
and a fixed-slot decode tier joined by explicit :class:`PageHandoff`
remaps; ``speculative`` drafts with a CSB-pruned copy of the target and
verifies ``spec_k``-token runs in one multi-position decode step;
``router`` places a request trace over N engine replicas (load-aware
through ``simulate_admission``) and simulates fleet-wide SLO attainment;
``scheduler`` owns request admission and slot- and page-granular cache
writes; ``paging`` the fixed-size token-page pool (free list, dense page
table, refcounted prefix trie) behind the paged cache. The exports are
JAX's; ``shard_cell_params`` partitions an RNN cell's CSB weights over a
``DeviceMesh``'s "model" axis for ``rnn_serve_frames(mesh=...)``.
"""
from .config import EngineConfig, resolve_config  # noqa: F401
from .disagg import (
    DecodeTier,
    PageHandoff,
    PrefillTier,
    serve_disaggregated,
)
from .engine import (
    ServeResult,
    bucket_len,
    generate,
    rnn_serve_frames,
    serve_continuous,
    shard_cell_params,
)
from .paging import PagePool, SharedInfo, pages_for
from .router import (
    POLICIES,
    Router,
    RouterResult,
    make_arrival_trace,
    route,
    simulate_replicas,
)
from .speculative import (
    derive_draft_params,
    generate_speculative,
    serve_continuous_speculative,
)
from .scheduler import (
    Request,
    SlotScheduler,
    cache_len_of,
    copy_page_cache,
    evict_slot,
    evict_slot_state,
    fit_cache_len,
    grow_cache,
    insert_paged_cache,
    insert_paged_span,
    insert_slot_cache,
    simulate_admission,
)

__all__ = [
    "EngineConfig", "ServeResult", "bucket_len",
    "generate", "rnn_serve_frames", "serve_continuous", "shard_cell_params",
    "DecodeTier", "PageHandoff", "PrefillTier", "serve_disaggregated",
    "POLICIES", "Router", "RouterResult", "make_arrival_trace", "route",
    "simulate_replicas",
    "PagePool", "SharedInfo", "pages_for",
    "derive_draft_params", "generate_speculative",
    "serve_continuous_speculative",
    "Request", "SlotScheduler", "cache_len_of", "copy_page_cache",
    "evict_slot", "evict_slot_state", "fit_cache_len", "grow_cache",
    "insert_paged_cache", "insert_paged_span", "insert_slot_cache",
    "simulate_admission",
]
