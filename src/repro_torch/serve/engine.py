"""Serving engines, ported from ``repro.serve.engine``.

``generate`` — prefill a batch of prompts, then greedy/temperature decode
one token at a time through the contiguous cache (or, with
``config.speculative``, through ``serve.speculative``).

``serve_continuous`` — the production shape for decoder LMs: a fixed
batch of decode *slots* fed by :class:`SlotScheduler`. Requests with
mixed prompt lengths arrive over time; a finished request's slot is
evicted and the next queued prompt prefilled into it mid-decode. The
slots hold contiguous worst-case-length caches, or (``paged=True``) share
the ``serve.paging`` block pool (admission by free pages, page-table
decode, pow2 prompt-bucketed prefill, optional prefix sharing), and
``use_kernel=True`` runs paged decode attention through the
paged-attention CUDA kernel.

``rnn_serve_frames`` — the paper's own serving shape: frame-by-frame RNN
inference (one MVM-bound cell step per frame) with CSB-compressed
weights; it returns per-frame outputs and the wall-clock time per frame,
so the faster-than-realtime criterion (<500 us/frame for speech) can be
checked on the card. With a ``DeviceMesh`` (one process per rank) its
CSB weights are partitioned over the mesh's "model" axis and run through
kernel B3, and the frame batch is split over the other axes.

The LM engines take ``mesh=`` (a ``DeviceMesh``, one process a rank, each
rank calling the engine alike; or the active Rules' mesh) and ``policy=``:
the parameters are placed on ``dist.rules.csb_shard_specs``, the caches
and pools on ``cache_specs``, tokens and positions on ``batch_specs``,
and every prefill and step runs under the mesh's activation rules
(:class:`_Runner`). Every rank returns the one-device run's tokens.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cells import CellGraph, cell_apply, init_state
from repro_torch.dist.api import (
    NamedSharding, Rules, axis_sizes, current_rules, fit_spec, is_dtensor,
    place, place_tree, plain_as_replicated, require_mesh, take_whole,
    to_placements, use_rules, whole,
)
from repro_torch.models import ModelConfig
from repro_torch.models import lm as LM
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

from .config import EngineConfig, resolve_config
from .paging import PagePool, pages_for
from .scheduler import (
    _TIME_KEYS, Request, SlotScheduler, cache_len_of, copy_page_cache,
    evict_slot, evict_slot_state, fit_cache_len, grow_cache,
    insert_paged_cache, insert_paged_span, insert_slot_cache,
)


def bucket_len(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the prefill-shape bucket.

    Padding prompts up to pow2 buckets bounds the number of distinct
    prefill shapes at O(log max_len) for arbitrary length traces (the
    floor merges the tiny lengths into one bucket)."""
    return 1 << max(max(n, floor) - 1, 0).bit_length()


class _Runner:
    """One (params, cfg, mesh, policy) serving context: holds the
    parameters (placed on the mesh once), one fp32 copy of the head for
    the logits product (so that a low-precision model does not cast its
    (d, V) head on every step; ``head=`` shares another runner's; on a
    mesh it keeps its weight's vocab split), and the cold-call
    bookkeeping, and runs every prefill and step under its Rules.

    Rules precedence, JAX's: an explicit ``mesh=`` derives
    ``activation_rules(cfg, mesh, policy)``; with no mesh argument a
    caller's ambient ``use_rules`` scope is honoured as it stands (its
    mesh and its table). A trivial mesh is no mesh. On a mesh the
    parameters are placed on ``csb_shard_specs`` (parameters already
    placed, another runner's, are taken as they are), tokens and
    positions on ``batch_specs(cfg, "decode")``; the caller places the
    caches (:meth:`place_cache`) and replicates a prefilled request
    cache before inserting it (:meth:`place_slot_cache`). Prefill and
    decode logits come back whole and alike on every rank.

    ``last_cold`` is True when the preceding prefill/step call was the
    first with its shape key (prefill length; decode-step variant): that
    call pays the one-time costs (the kernel library's load, the math
    libraries' workspaces), and the engine charges its wall time to
    ``compile_time_s`` instead of the steady-state throughput."""

    def __init__(self, params, cfg: ModelConfig, mesh=None, policy=None,
                 head=None):
        from repro_torch.dist.rules import (
            ShardingPolicy, activation_rules, csb_shard_specs,
        )
        self.cfg = cfg
        ambient = current_rules()
        self.mesh = _resolve_mesh(mesh)
        self.policy = policy or ShardingPolicy()
        if self.mesh is not None:
            if mesh is None and ambient is not None:
                self.rules = ambient
            else:
                self.rules = activation_rules(cfg, self.mesh, self.policy)
            if not _placed(params):
                specs = csb_shard_specs(params, self.mesh,
                                        policy=self.policy)
                params = place_tree(_copy_tree(params),
                                    _named(self.mesh, specs))
        else:
            # meshless rules are inert for shard()
            self.rules = ambient or Rules()
        self.params = params
        self.head = LM.head_f32(params, cfg) if head is None else head
        self.last_cold = False
        self._seen_keys: set = set()

    def _call_cold(self, key, call):
        with use_rules(self.rules), plain_as_replicated(
                self.mesh is not None):
            out = call()
        self.last_cold = key not in self._seen_keys
        self._seen_keys.add(key)
        return out

    def prefill(self, tokens: torch.Tensor, last_pos=None):
        key = ("prefill", tuple(tokens.shape), last_pos is not None)
        return self._call_cold(key, lambda: LM.prefill(
            self.params, {"tokens": tokens}, self.cfg, last_pos=last_pos,
            head=self.head))

    def prefill_partial(self, tokens: torch.Tensor, ctx: dict, start: int,
                        last_pos: int):
        """Prefill a prompt suffix against gathered shared-prefix pages
        (``ctx`` rides whole on every rank, as JAX replicates it)."""
        ctx = self.place_slot_cache(ctx)
        key = ("prefill_partial", tuple(tokens.shape), cache_len_of(ctx))
        return self._call_cold(key, lambda: LM.prefill_partial(
            self.params, {"tokens": tokens}, ctx, self.cfg, start=start,
            last_pos=last_pos, head=self.head))

    def _batch_placed(self, key: str, x: torch.Tensor):
        """``x`` placed on ``batch_specs(cfg, "decode")[key]`` (a spec no
        dim of ``x`` can carry leaves it plain: replicated)."""
        from repro_torch.dist.rules import batch_specs
        if self.mesh is None or x.ndim == 0:
            return x
        spec = fit_spec(batch_specs(self.cfg, "decode", self.mesh)[key],
                        tuple(x.shape), self.mesh)
        if spec is None:
            return x
        return place(x, NamedSharding(self.mesh,
                                      to_placements(spec, self.mesh)))

    def place_cache(self, cache: dict, paged: bool = False) -> dict:
        """The whole ``cache`` (every rank alike) placed on
        ``cache_specs`` (``paged=``: the pools' pages over "data"); the
        cache itself off a mesh."""
        from repro_torch.dist.rules import cache_specs
        if self.mesh is None:
            return cache
        specs = cache_specs(self.cfg, cache, self.mesh, self.policy,
                            paged=paged)
        return place_tree(_copy_tree(cache), _named(self.mesh, specs))

    def place_slot_cache(self, req_cache: dict) -> dict:
        """A freshly prefilled request cache made whole on every rank
        before it is written into the batch cache (JAX replicates it:
        one request's worth); the cache itself off a mesh."""
        if self.mesh is None:
            return req_cache
        return _map_tree(whole, req_cache)

    def step(self, cache, tokens, pos):
        key = ("step", torch.as_tensor(pos).ndim)
        if self.mesh is not None:
            pos = self._batch_placed("pos", torch.as_tensor(
                pos, device=tokens.device))
            tokens = self._batch_placed("tokens", tokens)
        return self._call_cold(key, lambda: LM.decode_step(
            self.params, cache, tokens, pos, self.cfg, head=self.head))

    def step_paged(self, cache, tokens, pos, page_table,
                   use_kernel: bool = False):
        key = ("paged", pos.ndim, use_kernel)
        if self.mesh is not None:
            tokens = self._batch_placed("tokens", tokens)
            pos = self._batch_placed("pos", pos)
        return self._call_cold(key, lambda: LM.decode_step_paged(
            self.params, cache, tokens, pos, page_table, self.cfg,
            use_kernel=use_kernel, head=self.head))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _copy_tree(tree):
    """A new tree of dicts and lists over the same tensors (placing it
    replaces its leaves, not the caller's)."""
    return _map_tree(lambda t: t, tree)


def _named(mesh, placements):
    """Each leaf's placements (a tuple, one per mesh dim) or spec as a
    ``NamedSharding`` on ``mesh``."""
    from repro_torch.dist.api import P

    def one(pl):
        return NamedSharding(mesh, to_placements(pl, mesh)
                             if isinstance(pl, P) else tuple(pl))
    if isinstance(placements, dict):
        return {k: _named(mesh, v) for k, v in placements.items()}
    if isinstance(placements, list):
        return [_named(mesh, v) for v in placements]
    return one(placements)


def _placed(tree) -> bool:
    """Whether the tree's first tensor is a DTensor (placed already)."""
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return is_dtensor(tree)


def _check_text_inputs(cfg: ModelConfig, caller: str) -> None:
    """Raise for an image-token model: the engines prefill a request's
    tokens alone and have no ``img_embeds`` to pass (JAX's fail on the
    missing key)."""
    if cfg.n_img_tokens:
        raise NotImplementedError(
            f"{caller} prefills token ids alone and passes no img_embeds, "
            f"which the image-token model {cfg.name} needs; run "
            "models.lm.prefill and decode_step with batch['img_embeds']")


def _sampler(temperature: float, generator: torch.Generator | None):
    """Greedy (``temperature <= 0``: argmax, first index on ties, as
    ``jnp.argmax``) or a categorical draw from ``generator``. JAX draws
    from ``jax.random`` keys, which torch cannot reproduce: only the
    greedy path is token-comparable across the two packages."""
    def sample(lg):
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.to(torch.float32) / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        idx = torch.multinomial(flat, 1, generator=generator)
        return idx.reshape(probs.shape[:-1])

    return sample


# ---------------------------------------------------------------------------
# fixed-batch generate
# ---------------------------------------------------------------------------

def generate(params, cfg: ModelConfig, tokens,
             config: EngineConfig | None = None,
             generator: torch.Generator | None = None, *, mesh=None,
             policy=None, device=None) -> torch.Tensor:
    """tokens: (B, S_prompt) ids, or (B, S_prompt, K) for a K-codebook
    model (array or tensor). Returns (B, S + new), or (B, S + new, K),
    int64 on ``device`` (``None`` means the card; parameters move there).

    Prefills the batch, then decodes ``config.max_new_tokens`` tokens one
    step at a time through the contiguous cache, every row at the same
    (scalar) position. Greedy decoding (``temperature=0``) gives the JAX
    package's tokens; at ``temperature > 0`` tokens are drawn from
    ``generator`` (a ``torch.Generator`` on ``device``; default: a fresh
    one seeded 0). With ``config.speculative`` a CSB-pruned self-draft
    proposes ``spec_k``-token runs that the target verifies in one
    multi-position decode step (``serve.speculative``); tokens are
    identical to the plain path at temperature 0.

    A codebook model samples its K codebooks at each step, each from its
    own V logits. An image-token model raises ``NotImplementedError``:
    ``generate`` passes its prefill tokens alone, no ``img_embeds`` (JAX's
    fails on the missing key); drive ``models.lm.prefill`` and
    ``decode_step`` with ``batch["img_embeds"]`` instead.

    With ``mesh=`` (or the active Rules' mesh; ``policy=`` a
    ``ShardingPolicy``), called alike on every rank, the parameters,
    cache and batch run placed on the mesh (:class:`_Runner`) and every
    rank returns the one-device tokens; at ``temperature > 0`` every rank
    draws from a generator in the same starting state."""
    scfg = resolve_config(config, caller="generate")
    _check_text_inputs(cfg, "generate()")
    if scfg.speculative:
        from .speculative import generate_speculative
        return generate_speculative(params, cfg, tokens, scfg, generator,
                                    mesh=mesh, policy=policy, device=device)
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape[:2]
    total = scfg.cache_len or (s + scfg.max_new_tokens)
    runner = _Runner(_to_device(params, dev), cfg, mesh, policy)
    if generator is None and scfg.temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(scfg.temperature, generator)
    with torch.no_grad():
        logits, cache = runner.prefill(tokens)
        # right-size the cache for the decode loop (whole on a mesh, then
        # placed on cache_specs)
        cache = runner.place_cache(grow_cache(
            runner.place_slot_cache(cache), total - cache_len_of(cache)))
        out = [tokens]
        cur = sample(logits)[:, None]
        for i in range(scfg.max_new_tokens):
            out.append(cur)
            lg, cache = runner.step(cache, cur, s + i)
            cur = sample(lg[:, -1])[:, None]
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeResult:
    """Outcome of a continuous-batching run."""

    tokens: dict[int, list[int]]      # rid -> generated token ids
    stats: dict                       # scheduler stats + throughput
    wall_s: float

    @property
    def occupancy(self) -> float:
        return self.stats["occupancy"]

    @property
    def tokens_per_sec(self) -> float:
        return self.stats["tokens_per_sec"]


def _gather_ctx(cache: dict, pages) -> dict:
    """Pull the shared-prefix pages out of the live paged cache as a
    contiguous per-layer context for the partial prefill. ``pages`` is a
    host array of physical page ids (scratch-padded to a pow2 count, as
    the JAX engine pads it to bound its compiled variants); each time
    leaf (L, N, P, ...) gathers to (L, 1, len(pages) * P, ...)."""
    out = {}
    for key, leaf in cache.items():
        assert key in _TIME_KEYS, \
            "prefix sharing needs an all-pool cache (attn, mla)"
        idx = torch.as_tensor(np.asarray(pages, np.int64),
                              device=leaf.device)
        g = take_whole(leaf, 1, idx)
        out[key] = g.reshape((g.shape[0], 1, g.shape[1] * g.shape[2])
                             + tuple(g.shape[3:]))
    return out


# The paged admission and decode protocol, shared by ``serve_continuous``
# and the tiers of ``serve.disagg`` (and the target side of
# ``serve.speculative``): one copy, so that the engines cannot drift.

def _trace_cache_len(cache_len: int | None, requests: list[Request]) -> int:
    """The per-slot cache length of a trace (``cache_len``, or the
    longest prompt + new tokens); raises when a request does not fit."""
    cache_len = cache_len or max(
        r.prompt_len + r.max_new_tokens for r in requests)
    short = [r for r in requests
             if r.prompt_len + r.max_new_tokens > cache_len]
    if short:
        raise ValueError(
            f"cache_len={cache_len} cannot hold request(s) "
            f"{[r.rid for r in short]}")
    return cache_len


def _admissions(sched: SlotScheduler, one_at_a_time: bool):
    """One loop turn's admissions. Under the prefix cache one request at
    a time: each prompt registers right after its own prefill, so the
    NEXT admission's trie match — even in the same step — can already
    share it. Without the cache, one batched ``admit()`` call keeps the
    original page_stall accounting."""
    if not one_at_a_time:
        yield from sched.admit()
        return
    while True:
        batch = sched.admit(limit=1)
        if not batch:
            return
        yield batch[0]


def _shared_ctx(pool: PagePool, cache: dict, slot: int):
    """(SharedInfo, gathered context) of a trie-matched admission, the
    partial prefill's input; (None, None) on no match. The page row is
    scratch-padded to a pow2 count, as the JAX engine pads it."""
    info = pool.shared_info(slot)
    if info is None or info.shared_pages == 0:
        return None, None
    sp = info.shared_pages
    n_pad = 1 << max(sp - 1, 0).bit_length()
    ctx_row = np.concatenate([
        pool.slot_row(slot)[:sp],
        np.full(n_pad - sp, pool.scratch_page, np.int32)])
    return info, _gather_ctx(cache, ctx_row)


def _prefill_request(runner: _Runner, tokens: np.ndarray, dev, bucket: bool,
                     info=None, ctx=None):
    """Prefill one prompt: on a trie match (``info``) only the suffix,
    against the gathered ``ctx`` (a match of no pages is none);
    pow2-bucketed when ``bucket``.
    Returns (logits, single-request cache (whole on a mesh), tokens
    prefilled)."""
    plen = int(tokens.shape[0])
    if info is not None and info.shared_pages:
        sstart = info.suffix_start
        s_real = plen - sstart
        suffix = tokens[sstart:]
        if bucket:
            suffix = np.pad(suffix, [(0, bucket_len(s_real) - s_real)])
        logits, req_cache = runner.prefill_partial(
            torch.as_tensor(suffix, device=dev)[None], ctx, start=sstart,
            last_pos=s_real - 1)
        n = int(suffix.shape[0])
    elif bucket:
        padded = np.pad(tokens, [(0, bucket_len(plen) - plen)])
        logits, req_cache = runner.prefill(
            torch.as_tensor(padded, device=dev)[None], last_pos=plen - 1)
        n = int(padded.shape[0])
    else:
        logits, req_cache = runner.prefill(
            torch.as_tensor(tokens, device=dev)[None])
        n = plen
    return logits, runner.place_slot_cache(req_cache), n


def _insert_prefilled(cache: dict, pool: PagePool, slot: int,
                      req_cache: dict, tokens: np.ndarray, info=None) -> dict:
    """Map a prefilled request into its slot's pages and register its
    prompt in the trie (when the pool has one). On a trie match
    (``info``) the divergence page is copied first, BEFORE the suffix
    write lands, then the prompt's pages are ensured and the suffix
    span written; else the whole cache is written over the slot's pages,
    scratch-padded to a pow2 count as the JAX engine pads them (the
    scratch page swallows the pad). Recurrent state leaves go to the
    slot's start. Returns the cache."""
    plen = int(tokens.shape[0])
    if info is not None and info.shared_pages:
        cow = pool.cow_if_needed(slot)
        if cow is not None:
            cache = copy_page_cache(cache, *cow)
        pool.ensure(slot, plen)
        cache = insert_paged_span(cache, req_cache, pool.slot_row(slot),
                                  info.suffix_start,
                                  plen - info.suffix_start, slot)
    else:
        pool.ensure(slot, plen)
        phys = list(pool.slot_pages(slot))
        n_pad = 1 << max(len(phys) - 1, 0).bit_length()
        phys += [pool.scratch_page] * (n_pad - len(phys))
        req_cache = fit_cache_len(req_cache, len(phys) * pool.page_size)
        cache = insert_paged_cache(cache, req_cache, phys, slot)
    if pool.prefix_cache:
        # future admissions may now share this prompt
        pool.register_prefix(slot, tokens)
    return cache


def _paged_step(runner: _Runner, cache: dict, cur: torch.Tensor,
                pool: PagePool, pos_host: np.ndarray, active: np.ndarray,
                use_kernel: bool):
    """One paged decode step over every slot: map the page each live
    slot writes (alloc-on-grow), then the page-table step. Returns
    (logits, cache)."""
    for i in np.flatnonzero(active):
        pool.ensure(int(i), int(pos_host[i]) + 1)
    pool.tick()
    return runner.step_paged(cache, cur,
                             torch.as_tensor(pos_host, device=cur.device),
                             pool.device_table(), use_kernel=use_kernel)


def serve_continuous(params, cfg: ModelConfig, requests: list[Request],
                     config: EngineConfig | None = None, *, mesh=None,
                     policy=None, generator: torch.Generator | None = None,
                     device=None) -> ServeResult:
    """Serve ``requests`` (mixed prompt lengths, arriving over time)
    through ``config.n_slots`` continuously-batched decode slots.

    Parameters (as ``models.lm.init_params`` or
    ``convert.lm_params_from_numpy`` make them) move to ``device``
    (``None`` means the card; a no-op where they already lie there).
    Each decode step runs every slot at its own position; admission
    prefills each arrived prompt and writes its cache into the freed
    slot. Greedy decoding (``temperature=0``) gives the JAX package's
    tokens, paged or not, and matches ``generate`` token for token.

    ``paged=False`` gives every slot a contiguous ``cache_len`` cache.
    ``paged=True`` backs the slots with a shared pool of ``pool_pages``
    fixed-size token pages (``page_size`` each; default pool = the full
    contiguous capacity). Slots map logical positions to physical pages
    through a dense page table (``serve.paging``); admission goes **by
    free pages, not free slots**, each request reserving only its own
    worst case. Pages free mid-decode the moment a request finishes.

    ``use_kernel=True`` (paged only) routes decode attention through the
    paged-attention kernel (``kernels.paged_attn_decode``): the
    page-table walk happens inside the kernel instead of a materialized
    ``(B, max_pages*P)`` gather; sampled tokens are unchanged.

    ``bucket_prompts`` (default: on when paged) right-pads each prompt to
    a pow2 **bucket** before prefill. Causal attention makes right
    padding invisible to real positions, so sampled tokens are
    unchanged.

    ``prefix_cache=True`` (paged only) keeps prompt pages in a refcounted
    radix trie after their request finishes and shares them across
    requests: an admission whose prompt prefix matches pages already in
    the pool maps them, prefills only the suffix
    (``models.lm.prefill_partial``), and copies a partially shared page
    before its first write. Sampled tokens are identical to
    ``prefix_cache=False``; ``stats["prefix_hits"]`` and
    ``stats["shared_pages"]`` count the sharing and
    ``stats["prefill_tokens"]`` the prefill work done.

    ``speculative=True`` dispatches to
    :func:`serve.speculative.serve_continuous_speculative`.

    At ``temperature > 0`` tokens are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; default: a fresh one seeded 0).

    Throughput accounting: ``stats["tokens_per_sec"]`` divides by the
    FULL wall clock, first calls included. ``stats["compile_time_s"]``
    isolates the first call of each prefill shape and decode-step
    variant (see :class:`_Runner`) and ``stats["steady_tokens_per_sec"]``
    is the decode throughput over the other steps only (0.0 when every
    step was cold).

    With :mod:`repro_torch.obs` enabled the run also emits per-request
    lifecycle spans (queue wait -> prefill -> TTFT -> decode), per-step
    spans and pool/occupancy gauge timelines, as the JAX engine does.

    With ``mesh=`` (or the active Rules' mesh; ``policy=`` a
    ``ShardingPolicy``), called alike on every rank with the whole trace,
    the parameters, caches and batch run placed on the mesh
    (:class:`_Runner`; a pool's pages split over "data" where their count,
    scratch page included, divides) and every rank returns the one-device
    tokens; ``stats["sharded"]`` says so.
    """
    if cfg.n_codebooks:
        raise NotImplementedError(
            "serve_continuous drives single-stream token ids; codebook "
            "models go through generate()")
    _check_text_inputs(cfg, "serve_continuous")
    # invalid combinations (prefix_cache without paged, ...) raise
    # ValueError inside EngineConfig.__post_init__
    config = resolve_config(config, caller="serve_continuous")
    if config.speculative:
        from .speculative import serve_continuous_speculative
        return serve_continuous_speculative(params, cfg, requests, config,
                                            mesh=mesh, policy=policy,
                                            generator=generator,
                                            device=device)
    dev = resolve_device(device)
    n_slots, temperature = config.n_slots, config.temperature
    cache_len, paged = config.cache_len, config.paged
    page_size, pool_pages = config.page_size, config.pool_pages
    use_kernel = config.use_kernel
    bucket = (config.bucket_prompts if config.bucket_prompts is not None
              else paged)
    bucket = bucket and cfg.mixer in ("attn", "mla")
    prefix = config.prefix_cache and cfg.mixer in ("attn", "mla")
    if not requests:
        stats = SlotScheduler(n_slots).stats()
        stats.update(cache_len=0, tokens_per_sec=0.0, paged=paged,
                     bucketed_prefill=bucket, prefix_cache=prefix,
                     prefill_tokens=0, compile_time_s=0.0,
                     steady_tokens_per_sec=0.0,
                     sharded=_resolve_mesh(mesh) is not None)
        if paged:
            stats["paging"] = PagePool(
                page_size, 1 if pool_pages is None else pool_pages,
                n_slots, 1, device=dev).summary()
            stats["page_stalls"] = 0
        return ServeResult({}, stats, 0.0)
    cache_len = _trace_cache_len(cache_len, requests)

    params = _to_device(params, dev)
    runner = _Runner(params, cfg, mesh, policy)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(temperature, generator)

    pool = None
    if paged:
        max_pages = pages_for(cache_len, page_size)
        # explicit pool_pages=0 must reject (PagePool raises), not
        # silently fall back to the full contiguous footprint
        n_pool = (n_slots * max_pages if pool_pages is None
                  else pool_pages)
        pool = PagePool(page_size, n_pool, n_slots, max_pages,
                        prefix_cache=prefix, device=dev)
    sched = SlotScheduler(n_slots, pool=pool)
    for r in requests:
        sched.submit(r)

    dtype = getattr(torch, cfg.dtype)
    if paged:
        cache = LM.init_paged_cache(cfg, pool.n_pages, page_size, n_slots,
                                    dtype, dev)
    else:
        cache = LM.init_cache(cfg, n_slots, cache_len, dtype, dev)
    cache = runner.place_cache(cache, paged=paged)
    cur = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)

    prefill_tokens = 0
    # observability handles, fetched once per run: ``tr``/``reg`` are
    # None when obs is off and every emit below branches on that — the
    # cold/steady split is ALWAYS accounted, it only costs
    # perf_counter_ns calls around already-blocking work
    tr = obs_trace.get()
    reg = obs_metrics.get()
    obs_on = tr is not None or reg is not None
    req_clock: dict[int, dict] = {}    # rid -> lifecycle timestamps (ns)
    compile_ns = 0
    steady_ns = 0
    steady_tokens = 0

    def _mark_eligible():
        # stamp the wall time each queued request first became
        # admissible (its arrival step reached) — queue wait and TTFT
        # are measured from here, not from engine start
        now_ns = time.perf_counter_ns()
        for rid in sched.arrived_pending():
            req_clock.setdefault(rid, {})["eligible"] = now_ns

    def _finish_req(rid: int, t_fin: int):
        rc = req_clock.get(rid, {})
        t_first = rc.get("first")
        if t_first is None:
            return
        n_dec = len(sched.results.get(rid, ())) - 1
        if tr is not None:
            tr.complete("serve/req/decode", t_first, t_fin - t_first,
                        track=f"req {rid}",
                        args={"rid": rid, "decode_tokens": n_dec})
            tr.instant("serve/req/finish", track=f"req {rid}",
                       args={"rid": rid})
        if reg is not None and n_dec > 0:
            reg.histogram("serve/req/decode_per_token_us").observe(
                (t_fin - t_first) / 1e3 / n_dec)

    t0 = time.perf_counter()
    with torch.no_grad():
        while sched.has_work():
            if obs_on:
                _mark_eligible()
            for slot, req in _admissions(sched, prefix):
                tokens = np.asarray(req.tokens)
                plen = req.prompt_len
                if obs_on:
                    t_adm = time.perf_counter_ns()
                    rc = req_clock.setdefault(req.rid, {})
                    t_el = rc.get("eligible", t_adm)
                    rc["admit"] = t_adm
                    if tr is not None:
                        tr.complete("serve/req/queue_wait", t_el,
                                    t_adm - t_el, track=f"req {req.rid}",
                                    args={"rid": req.rid, "slot": slot})
                    if reg is not None:
                        reg.histogram("serve/req/queue_wait_us").observe(
                            (t_adm - t_el) / 1e3)
                t_pf = time.perf_counter_ns()
                info, ctx = (_shared_ctx(pool, cache, slot) if prefix
                             else (None, None))
                shared = info is not None
                logits, req_cache, n = _prefill_request(
                    runner, tokens, dev, bucket, info, ctx)
                prefill_tokens += n
                first = int(sample(logits).reshape(-1)[0])
                t_ft = time.perf_counter_ns()
                if runner.last_cold:
                    compile_ns += t_ft - t_pf
                if obs_on:
                    rc = req_clock.setdefault(req.rid, {})
                    rc["first"] = t_ft
                    t_el = rc.get("eligible", t_pf)
                    if tr is not None:
                        track = f"req {req.rid}"
                        tr.complete("serve/req/prefill", t_pf, t_ft - t_pf,
                                    track=track,
                                    args={"rid": req.rid, "tokens": plen,
                                          "shared": shared,
                                          "cold": runner.last_cold})
                        tr.complete("serve/req/ttft", t_el, t_ft - t_el,
                                    track=track, args={"rid": req.rid})
                    if reg is not None:
                        reg.histogram("serve/req/prefill_us").observe(
                            (t_ft - t_pf) / 1e3)
                        reg.histogram("serve/req/ttft_us").observe(
                            (t_ft - t_el) / 1e3)
                if sched.started(slot, first):
                    if paged:
                        cache = _insert_prefilled(cache, pool, slot,
                                                  req_cache, tokens, info)
                    else:
                        if bucket:
                            # drop pad positions; decode overwrites each
                            # position before the mask ever exposes it
                            req_cache = fit_cache_len(req_cache, plen)
                        cache = insert_slot_cache(cache, req_cache, slot)
                    cur[slot, 0] = first
                elif obs_on:
                    # max_new_tokens == 1: finished off the prefill alone
                    _finish_req(req.rid, time.perf_counter_ns())
            active = sched.active_mask()
            if not active.any():
                sched.idle_tick()
                continue
            pos_host = sched.positions()
            n_active = int(active.sum())
            rid_by_slot = sched.slot_rids() if obs_on else None
            t_st = time.perf_counter_ns()
            if paged:
                lg, cache = _paged_step(runner, cache, cur, pool, pos_host,
                                        active, use_kernel)
            else:
                lg, cache = runner.step(cache, cur,
                                        torch.as_tensor(pos_host, device=dev))
            nxt = sample(lg[:, -1])
            # the host pull below waits for the step, so the wall time
            # around it is the true per-step latency (the engine is
            # host-synchronous per token by construction)
            nxt_host = nxt.cpu().numpy()
            t_en = time.perf_counter_ns()
            if runner.last_cold:
                compile_ns += t_en - t_st
            else:
                steady_ns += t_en - t_st
                steady_tokens += n_active
            if tr is not None:
                tr.complete("serve/decode_step", t_st, t_en - t_st,
                            track="engine",
                            args={"active": n_active,
                                  "cold": runner.last_cold})
            if reg is not None:
                reg.histogram("serve/step/wall_us").observe(
                    (t_en - t_st) / 1e3)
                reg.gauge("serve/slots/active").set(n_active)
            for slot in sched.advance(nxt_host):
                # paged: the pages went back to the allocator inside the
                # scheduler, and only per-slot recurrent state needs the
                # device zero; contiguous: the whole slot is zeroed
                cache = (evict_slot_state(cache, slot) if paged
                         else evict_slot(cache, slot))
                if obs_on:
                    _finish_req(rid_by_slot[slot], time.perf_counter_ns())
            cur = nxt[:, None].to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    stats = sched.stats()
    stats["cache_len"] = cache_len
    stats["paged"] = paged
    stats["bucketed_prefill"] = bucket
    stats["prefix_cache"] = prefix
    stats["prefill_tokens"] = prefill_tokens
    stats["tokens_per_sec"] = round(
        stats["generated_tokens"] / wall, 3) if wall > 0 else 0.0
    stats["compile_time_s"] = round(compile_ns / 1e9, 6)
    stats["steady_tokens_per_sec"] = round(
        steady_tokens / (steady_ns / 1e9), 3) if steady_ns > 0 else 0.0
    stats["sharded"] = runner.mesh is not None
    return ServeResult(sched.results, stats, wall)


def _to_device(tree, dev):
    return _map_tree(lambda t: t.to(dev), tree)


def _resolve_mesh(mesh):
    """Explicit mesh arg, else the active Rules' mesh; trivial -> None.
    A mesh is a ``torch.distributed.device_mesh.DeviceMesh``."""
    if mesh is None:
        mesh = getattr(current_rules(), "mesh", None)
    if mesh is None:
        return None
    return mesh if require_mesh(mesh).size() > 1 else None


def shard_cell_params(params: dict, mesh, axis_name: str = "model") -> dict:
    """Cycle-balance every ``PaddedCSB`` cell weight over
    ``mesh[axis_name]`` (``dist.csb_partition``'s greedy planner, run on
    the host by every rank alike; the ranks check that their plans agree)
    and place the tree with ``csb_shard_specs``: a weight split over the
    axis keeps this rank's shard alone, on the weight's device. After this,
    ``cell_apply`` under ``use_rules`` routes each MVM through kernel B3."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.core.csb_format import PaddedCSB, ShardedCSB
    from repro_torch.dist.csb_partition import check_plans, partition_padded
    from repro_torch.dist.rules import csb_shard_specs

    n_dev = axis_sizes(mesh)[axis_name]
    group = mesh.get_group(axis_name)
    out = {k: (partition_padded(w.to("cpu"), n_dev)[1]
               if isinstance(w, PaddedCSB) else w)
           for k, w in params.items()}
    check_plans([w.row_map for w in out.values()
                 if isinstance(w, ShardedCSB)], group)
    specs = csb_shard_specs(out, mesh, axis=axis_name)
    rank = dist.get_rank(group)
    for k, w in out.items():
        if isinstance(w, ShardedCSB):
            if isinstance(specs[k].vals, Shard):
                w = w.local(rank)
            out[k] = w.to(params[k].vals.device)
    return out


def _data_axes(mesh, axis_name: str) -> list[str]:
    """The mesh's other axes larger than 1: the frame batch is split over
    them, outer axis first."""
    return [a for a, n in axis_sizes(mesh).items()
            if a != axis_name and n > 1]


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` has arrived: a barrier over each axis in
    turn (a rank that passed all of them has seen every rank arrive)."""
    import torch.distributed as dist
    for a, n in axis_sizes(mesh).items():
        if n > 1:
            dist.barrier(group=mesh.get_group(a))


def _gather_batch(t: torch.Tensor, mesh, axes: list[str],
                  dim: int) -> torch.Tensor:
    """Undo the batch split: all-gather ``t`` along ``dim`` over each data
    axis, inner axis first."""
    import torch.distributed as dist
    for a in reversed(axes):
        parts = [torch.empty_like(t) for _ in range(axis_sizes(mesh)[a])]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group(a))
        t = torch.cat(parts, dim=dim)
    return t


def rnn_serve_frames(graph: CellGraph, params: dict, frames,
                     state: dict | None = None,
                     warmup: int | None = None,
                     *, config: EngineConfig | None = None, mesh=None,
                     axis_name: str = "model",
                     collect_frame_times: bool | None = None,
                     device=None):
    """frames: (T, B, in_dim) tensor or array. Weights may be dense
    tensors or ``PaddedCSB``; they, the frames and ``state`` are moved to
    ``device`` (``None`` means the card).

    ``config.frame_warmup`` / ``config.collect_frame_times`` are the
    :class:`EngineConfig` homes of the two knobs; the positional
    ``warmup`` and ``collect_frame_times`` arguments override them when
    given explicitly.

    With ``mesh=`` (a ``DeviceMesh``; or the active Rules' mesh), called
    on every rank with the whole ``frames``: the CSB weights are
    partitioned over ``mesh[axis_name]`` (``shard_cell_params``) and run
    through kernel B3, each rank serves its share of the batch along the
    other axes (where the batch divides among them, as JAX's
    divisibility guard has it; else every rank serves all of it), and the
    outputs and final state are gathered back, so that every rank returns
    what the unsharded call returns. A trivial mesh is no mesh.

    Returns (outputs (T,B,H), final state, us_per_frame). ``us_per_frame``
    comes from an unblocked pass over all frames that synchronises the
    device once, at its end: the throughput number. On a mesh it and the
    frame times are the rank's own wall clock, each pass started after a
    barrier.

    ``collect_frame_times=True`` appends a 4th element: a ``(T,)`` numpy
    array of per-frame wall microseconds from a second pass that waits
    for each frame before the next starts — the tail-latency (p99)
    number realtime audio cares about. That pass also records the
    ``serve/frame`` spans and the ``serve/frames/wall_us`` histogram when
    ``repro_torch.obs`` is enabled, after each frame's timing.

    With ``repro_torch.obs`` enabled the call also records the spans
    ``serve/frames/call`` (the whole call), ``serve/frames/prologue``
    (config, device, placement and state), ``serve/frames/sync`` (each
    synchronisation around the unblocked pass), ``serve/frames/step``
    (each frame's enqueue in the unblocked pass) and
    ``serve/frames/gather`` (stacking, and on a mesh gathering, the
    outputs); while a ``torch.profiler`` records, each is a range in its
    trace too."""
    tr = obs_trace.get()
    span = obs_trace.span if tr is None else tr.span
    with span("serve/frames/call"):
        with span("serve/frames/prologue"):
            fcfg = resolve_config(config, caller="rnn_serve_frames")
            if warmup is None:
                warmup = fcfg.frame_warmup
            if collect_frame_times is None:
                collect_frame_times = fcfg.collect_frame_times
            dev = resolve_device(device)
            frames = torch.as_tensor(frames, device=dev)
            if frames.dtype == torch.float64:
                # the JAX package computes in fp32 (x64 is off there)
                frames = frames.to(torch.float32)
            params = {k: w.to(dev) for k, w in params.items()}
            if state is not None:
                state = {k: v.to(dev) for k, v in state.items()}
            mesh = _resolve_mesh(mesh)
            rules, dp = current_rules(), []
            if mesh is not None:
                if axis_sizes(mesh).get(axis_name, 1) > 1:
                    params = shard_cell_params(params, mesh, axis_name)
                dp = _data_axes(mesh, axis_name)
                n_dp = math.prod(axis_sizes(mesh)[a] for a in dp)
                if frames.shape[1] % n_dp:  # JAX's guard: batch replicated
                    dp = []
                if dp:
                    index = 0
                    for a in dp:
                        index = (index * axis_sizes(mesh)[a]
                                 + mesh.get_local_rank(a))
                    per = frames.shape[1] // n_dp
                    frames = frames[:, index * per:(index + 1) * per]
                    if state is not None:
                        state = {k: v[index * per:(index + 1) * per]
                                 for k, v in state.items()}
                if rules is None or rules.mesh is not mesh:
                    rules = Rules(mesh=mesh)
            if rules is None:
                rules = Rules()
            if state is None:
                state = init_state(graph, tuple(frames.shape[1:-1]),
                                   torch.float32, device=dev)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))
        start = ((lambda: _barrier(mesh)) if mesh is not None
                 else (lambda: None))

        def step(st, x):
            return cell_apply(graph, params, x, st)

        n = frames.shape[0]
        with torch.no_grad(), use_rules(rules):
            for _ in range(warmup):
                step(state, frames[0])
            with span("serve/frames/sync"):
                sync()

            outs = []
            start()
            t0 = time.perf_counter()
            st = state
            for t in range(n):
                if tr is None:
                    y, st = step(st, frames[t])
                else:
                    with tr.span("serve/frames/step"):
                        y, st = step(st, frames[t])
                outs.append(y)
            with span("serve/frames/sync"):
                sync()
            dt = time.perf_counter() - t0

            frame_us = None
            if collect_frame_times:
                # a separate pass, so the throughput number above is
                # untouched by the per-frame waits; spans and histogram
                # are recorded after each frame's timing
                reg = obs_metrics.get()
                frame_us = np.empty(n)
                st2 = state
                start()
                for t in range(n):
                    f0 = time.perf_counter_ns()
                    _, st2 = step(st2, frames[t])
                    sync()
                    dur = time.perf_counter_ns() - f0
                    frame_us[t] = dur / 1e3
                    if tr is not None:
                        tr.complete("serve/frame", f0, dur, track="frames",
                                    args={"frame": t})
                    if reg is not None:
                        reg.histogram("serve/frames/wall_us").observe(
                            dur / 1e3)
            with span("serve/frames/gather"):
                ys = torch.stack(outs)
                if dp:
                    ys = _gather_batch(ys, mesh, dp, 1)
                    st = {k: _gather_batch(v, mesh, dp, 0)
                          for k, v in st.items()}
    us_per_frame = dt / n * 1e6
    if collect_frame_times:
        return ys, st, us_per_frame, frame_us
    return ys, st, us_per_frame
