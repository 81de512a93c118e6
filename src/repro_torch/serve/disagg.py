"""Disaggregated serving, ported from ``repro.serve.disagg``: a prefill
tier feeding a decode tier through explicit page handoffs.

Continuous batching interleaves two workloads of opposite shapes on one
engine: prefill is a bursty, throughput-bound matrix product over a
whole prompt; decode is a latency-bound single-token step that wants to
stay hot and uninterrupted. This module splits them:

* :class:`PrefillTier` — throughput tier: pow2 prompt-bucketed full
  prefill and trie-aware partial prefill (``prefill_partial`` against
  pages gathered from the decode tier's pool).
* :class:`DecodeTier` — latency tier: a fixed set of decode slots over
  its own :class:`~.paging.PagePool` and the vector-position paged decode
  step (through the paged-attention kernel with ``use_kernel=True``).
* :class:`PageHandoff` — the object crossing the boundary: one completed
  prefill (prompt, sampled first token, single-request cache) that
  :meth:`DecodeTier.accept` remaps into the decode pool — copy-on-write
  first when the suffix starts inside a trie-shared page, then page
  ``ensure`` and the write, then trie registration — so refcounts stay
  conserved under prefix sharing.

Each tier owns a runner; both share the parameters and one fp32 copy of
the head (``head=``). ``serve_disaggregated`` drives both tiers over one
:class:`~.scheduler.SlotScheduler` (admission by the decode pool's free
pages) and is token for token identical to ``serve_continuous`` on the
same trace: the same bucketed prefill, the same paged decode step, and
the same order of draws from the generator. With
:mod:`repro_torch.obs` enabled it emits the per-tier queue-wait
histograms, a ``serve/handoff`` span per handoff (with its page count)
and the decode tier's occupancy gauge, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import ModelConfig
from repro_torch.models import lm as LM
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

from .config import EngineConfig, resolve_config
from .engine import (
    ServeResult, _admissions, _check_text_inputs, _insert_prefilled,
    _paged_step, _prefill_request, _resolve_mesh, _Runner, _sampler,
    _shared_ctx, _to_device, _trace_cache_len,
)
from .paging import PagePool, SharedInfo, pages_for
from .scheduler import Request, SlotScheduler, evict_slot_state

__all__ = ["PageHandoff", "PrefillTier", "DecodeTier",
           "serve_disaggregated"]


@dataclasses.dataclass
class PageHandoff:
    """One completed prefill crossing the tier boundary.

    ``req_cache`` is the single-request contiguous cache the prefill
    produced (bucket-padded time extent); ``shared`` is the decode
    pool's trie match recorded at admission (None, or zero pages, when
    the prompt was prefilled whole). The handoff is inert data: nothing
    is mapped until :meth:`DecodeTier.accept` remaps it into the pool.
    """

    rid: int
    slot: int                      # decode-tier slot reserved at admission
    tokens: np.ndarray             # full prompt (trie registration key)
    prompt_len: int
    first_token: int               # sampled off the prefill logits
    req_cache: dict
    shared: SharedInfo | None
    created_ns: int                # prefill completion (queue-wait clock)

    @property
    def suffix_start(self) -> int:
        if self.shared is not None and self.shared.shared_pages > 0:
            return self.shared.suffix_start
        return 0


class PrefillTier:
    """Throughput tier: bucketed full prefill and trie-aware partial
    prefill. Produces :class:`PageHandoff` objects; never touches the
    decode pool. Prompts are bucketed only for the position-indexed
    mixers (attn, mla), as ``serve_continuous`` buckets them."""

    def __init__(self, params, cfg: ModelConfig, config: EngineConfig,
                 *, head=None, mesh=None, policy=None, device=None):
        self.device = resolve_device(device)
        self.runner = _Runner(params, cfg, mesh, policy, head=head)
        bucket = (config.bucket_prompts
                  if config.bucket_prompts is not None else True)
        self.bucket = bucket and cfg.mixer in ("attn", "mla")
        self.prefill_tokens = 0

    def run(self, req: Request, slot: int, sample, *,
            shared: SharedInfo | None = None,
            ctx: dict | None = None) -> PageHandoff:
        """Prefill one admitted request (suffix only on a trie match,
        against ``ctx`` gathered from the decode tier) and sample its
        first token. Returns the handoff for the decode tier."""
        tokens = np.asarray(req.tokens)
        logits, req_cache, n = _prefill_request(
            self.runner, tokens, self.device, self.bucket, shared, ctx)
        self.prefill_tokens += n
        first = int(sample(logits).reshape(-1)[0])
        return PageHandoff(rid=req.rid, slot=slot, tokens=tokens,
                           prompt_len=req.prompt_len, first_token=first,
                           req_cache=req_cache, shared=shared,
                           created_ns=time.perf_counter_ns())


class DecodeTier:
    """Latency tier: fixed decode slots over a private
    :class:`~.paging.PagePool`, accepting handoffs by page remap and
    stepping every active slot through the vector-position paged decode
    step (the paged-attention kernel with ``config.use_kernel``)."""

    def __init__(self, params, cfg: ModelConfig, config: EngineConfig,
                 cache_len: int, *, head=None, mesh=None, policy=None,
                 device=None):
        self.config = config
        dev = resolve_device(device)
        self.runner = _Runner(params, cfg, mesh, policy, head=head)
        self.prefix = config.prefix_cache and cfg.mixer in ("attn", "mla")
        max_pages = pages_for(cache_len, config.page_size)
        n_pool = (config.n_slots * max_pages
                  if config.pool_pages is None else config.pool_pages)
        self.pool = PagePool(config.page_size, n_pool, config.n_slots,
                             max_pages, prefix_cache=self.prefix,
                             device=dev)
        self.sched = SlotScheduler(config.n_slots, pool=self.pool)
        self.cache = self.runner.place_cache(LM.init_paged_cache(
            cfg, self.pool.n_pages, config.page_size, config.n_slots,
            getattr(torch, cfg.dtype), dev), paged=True)
        self.cur = torch.zeros((config.n_slots, 1), dtype=torch.int32,
                               device=dev)
        self.handoffs = 0
        self.handoff_pages = 0

    def shared_ctx(self, slot: int):
        """(SharedInfo, gathered ctx) for a trie-matched admission — the
        prefill tier's partial-prefill input. The page row is
        scratch-padded to a pow2 count, as the single engine pads it.
        (None, None) on no match."""
        return _shared_ctx(self.pool, self.cache, slot)

    def accept(self, h: PageHandoff) -> bool:
        """Remap a handoff into the decode pool: copy the divergence
        page when the suffix starts inside a shared page, ``ensure`` the
        prompt's pages, write the prefilled cache (state leaves at the
        slot's start), then register the prompt in the trie. Returns
        False when the request finished at prefill (``max_new_tokens ==
        1``: nothing is mapped)."""
        t_acc = time.perf_counter_ns()
        pool, slot = self.pool, h.slot
        alive = self.sched.started(slot, h.first_token)
        n_pages = 0
        if alive:
            self.cache = _insert_prefilled(
                self.cache, pool, slot, h.req_cache, h.tokens, h.shared)
            self.cur[slot, 0] = h.first_token
            n_pages = len(pool.slot_pages(slot))
        self.handoffs += 1
        self.handoff_pages += n_pages
        t_end = time.perf_counter_ns()
        tr = obs_trace.get()
        if tr is not None:
            tr.complete("serve/handoff", h.created_ns,
                        t_end - h.created_ns, track="handoff",
                        args={"rid": h.rid, "slot": slot,
                              "pages": n_pages,
                              "shared_pages": (h.shared.shared_pages
                                               if h.shared else 0)})
        reg = obs_metrics.get()
        if reg is not None:
            reg.counter("serve/handoff/count").inc()
            reg.counter("serve/handoff/pages").inc(n_pages)
            # decode-tier queue wait: prefill completion -> pages mapped
            reg.histogram("serve/disagg/handoff_queue_us").observe(
                (t_acc - h.created_ns) / 1e3)
        return alive

    def step(self, sample) -> tuple[list[int], int]:
        """One paged decode step over every active slot. Returns (freed
        slots, active count); sets ``runner.last_cold``."""
        sched, pool = self.sched, self.pool
        active = sched.active_mask()
        pos_host = sched.positions()
        lg, self.cache = _paged_step(self.runner, self.cache, self.cur,
                                     pool, pos_host, active,
                                     self.config.use_kernel)
        nxt = sample(lg[:, -1])
        nxt_host = nxt.cpu().numpy()        # waits: the true step latency
        freed = sched.advance(nxt_host)
        for slot in freed:
            # the pages went back inside the scheduler; per-slot
            # recurrent state needs the device-side zero
            evict_slot_state(self.cache, slot)
        self.cur = nxt[:, None].to(torch.int32)
        reg = obs_metrics.get()
        if reg is not None:
            reg.gauge("serve/tier/decode_active").set(int(active.sum()))
        return freed, int(active.sum())


def serve_disaggregated(params, cfg: ModelConfig,
                        requests: list[Request],
                        config: EngineConfig | None = None, *, mesh=None,
                        policy=None,
                        generator: torch.Generator | None = None,
                        device=None) -> ServeResult:
    """Serve ``requests`` through split prefill and decode tiers on
    ``device`` (``None`` means the card; parameters move there).

    Requires ``config.paged=True``: the handoff is a page remap into the
    decode tier's pool. Tokens are identical to ``serve_continuous`` with
    the same config on the same trace (the same bucketed prefill, the
    same paged step), and at ``temperature > 0`` too when both draw from
    generators in the same state: each admission draws its first token,
    then each step its tokens, in ``serve_continuous``'s order (default:
    a fresh generator seeded 0). Codebook and image-token models raise
    ``NotImplementedError``.

    With ``mesh=`` (``policy=``), called alike on every rank, each tier
    owns its own runner on the mesh (the decode tier's over the prefill
    tier's placed parameters and head), the decode pool is placed on
    ``cache_specs`` and a handoff crosses from the prefill tier into the
    decode pool on that one mesh; every rank returns the one-device
    tokens.
    """
    if cfg.n_codebooks:
        raise NotImplementedError(
            "serve_disaggregated drives single-stream token ids; "
            "codebook models go through generate()")
    _check_text_inputs(cfg, "serve_disaggregated")
    config = resolve_config(config, caller="serve_disaggregated")
    if not config.paged:
        raise ValueError(
            "serve_disaggregated requires config.paged=True (the "
            "prefill->decode handoff is a page remap)")
    dev = resolve_device(device)
    if not requests:
        stats = SlotScheduler(config.n_slots).stats()
        stats.update(cache_len=0, tokens_per_sec=0.0, paged=True,
                     disagg=True, bucketed_prefill=False,
                     prefix_cache=False, prefill_tokens=0,
                     handoffs=0, handoff_pages=0,
                     compile_time_s=0.0, steady_tokens_per_sec=0.0,
                     sharded=_resolve_mesh(mesh) is not None)
        stats["paging"] = PagePool(
            config.page_size,
            1 if config.pool_pages is None else config.pool_pages,
            config.n_slots, 1, device=dev).summary()
        stats["page_stalls"] = 0
        return ServeResult({}, stats, 0.0)
    cache_len = _trace_cache_len(config.cache_len, requests)

    params = _to_device(params, dev)
    prefill_tier = PrefillTier(params, cfg, config, mesh=mesh,
                               policy=policy, device=dev)
    decode_tier = DecodeTier(prefill_tier.runner.params, cfg, config,
                             cache_len, head=prefill_tier.runner.head,
                             mesh=mesh, policy=policy, device=dev)
    sched = decode_tier.sched
    for r in requests:
        sched.submit(r)
    if generator is None and config.temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(config.temperature, generator)
    prefix = decode_tier.prefix

    reg = obs_metrics.get()
    eligible_ns: dict[int, int] = {}
    compile_ns = steady_ns = steady_tokens = 0

    t0 = time.perf_counter()
    with torch.no_grad():
        while sched.has_work():
            if reg is not None:
                now_ns = time.perf_counter_ns()
                for rid in sched.arrived_pending():
                    eligible_ns.setdefault(rid, now_ns)
                reg.gauge("serve/tier/prefill_backlog").set(
                    len(sched.arrived_pending()))
            for slot, req in _admissions(sched, prefix):
                t_pf = time.perf_counter_ns()
                if reg is not None:
                    # prefill-tier queue wait: eligible -> prefill start
                    reg.histogram("serve/disagg/prefill_queue_us").observe(
                        (t_pf - eligible_ns.get(req.rid, t_pf)) / 1e3)
                info, ctx = (decode_tier.shared_ctx(slot) if prefix
                             else (None, None))
                h = prefill_tier.run(req, slot, sample, shared=info,
                                     ctx=ctx)
                if prefill_tier.runner.last_cold:
                    compile_ns += time.perf_counter_ns() - t_pf
                decode_tier.accept(h)
            if not sched.active_mask().any():
                sched.idle_tick()
                continue
            t_st = time.perf_counter_ns()
            _, n_active = decode_tier.step(sample)
            t_en = time.perf_counter_ns()
            if decode_tier.runner.last_cold:
                compile_ns += t_en - t_st
            else:
                steady_ns += t_en - t_st
                steady_tokens += n_active
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    stats = sched.stats()
    stats["cache_len"] = cache_len
    stats["paged"] = True
    stats["disagg"] = True
    stats["bucketed_prefill"] = prefill_tier.bucket
    stats["prefix_cache"] = prefix
    stats["prefill_tokens"] = prefill_tier.prefill_tokens
    stats["handoffs"] = decode_tier.handoffs
    stats["handoff_pages"] = decode_tier.handoff_pages
    stats["tokens_per_sec"] = round(
        stats["generated_tokens"] / wall, 3) if wall > 0 else 0.0
    stats["compile_time_s"] = round(compile_ns / 1e9, 6)
    stats["steady_tokens_per_sec"] = round(
        steady_tokens / (steady_ns / 1e9), 3) if steady_ns > 0 else 0.0
    stats["sharded"] = decode_tier.runner.mesh is not None
    return ServeResult(sched.results, stats, wall)

