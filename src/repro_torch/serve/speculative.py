"""Speculative decoding with a CSB-pruned self-draft, ported from
``repro.serve.speculative``.

The draft IS the target checkpoint run through the paper's own
projection (``core.pruning.csb_project`` at ``draft_prune_rate``): no
second checkpoint, no distillation. The projection leaves a masked
dense weight, so the draft runs the target's own dense path (no CSB
kernel), in JAX and here. Each round the draft proposes ``spec_k``
tokens autoregressively (single-token steps through a contiguous cache);
the target scores all of them in ONE multi-position decode step (s = k+1
query positions, ``models.layers._decode_mask``); standard rejection
sampling [Leviathan et al. 2023] then commits a prefix of the proposals
plus one target-sampled token, so the committed stream is distributed
exactly as target-only decoding at any temperature — and token for token
identical at temperature 0, where acceptance is ``draft == argmax``.

Cache bookkeeping per round (slot at committed frontier p, last
committed-but-unwritten token ``cur``):

- draft: k+1 contiguous single-token steps write [cur, d_1..d_k] at
  p..p+k and sample d_1..d_k. Stale draft KV past a rejection is
  overwritten next round before any query can attend it.
- target: one (k+1)-wide step writes [cur, d_1..d_k] at p..p+k and
  returns per-position logits pi_0..pi_k.
- commit n in [1, k_eff+1] tokens; ``PagePool.truncate(slot, p+n)``
  rolls the page table back past the first rejected position.

Randomness: every sampling decision draws from a ``torch.Generator``
seeded from (base seed, rid, token index, purpose) — purpose: proposal
or bonus sample, accept-u, residual resample — with NO round counter,
on the device that holds the logits. The same token index draws the
same numbers whatever spec_k is, so at temperature > 0 spec_k = N and
spec_k = 1 (prune rate 0) give identical tokens. JAX keys its draws with
``fold_in`` on ``jax.random`` keys, which torch cannot reproduce: only
the temperature-0 streams compare across the two packages.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.pruning import CSBSpec, csb_project
from repro_torch.models import ModelConfig
from repro_torch.models import lm as LM
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

from .config import EngineConfig
from .engine import (
    ServeResult, _Runner, _check_text_inputs, _insert_prefilled,
    _resolve_mesh, _sampler, _to_device, bucket_len,
)
from .paging import PagePool, pages_for
from .scheduler import (
    SlotScheduler, cache_len_of, evict_slot, evict_slot_state,
    fit_cache_len, grow_cache, insert_slot_cache,
)

F32 = torch.float32

# purposes of a draw (see module docstring)
_SAMPLE, _ACCEPT, _RESID = 0, 1, 2
# folded into the serve engine's base seed, as JAX folds it into its key
_SERVE_SALT = 0x5bec


def derive_draft_params(params: dict, prune_rate: float, *,
                        bm: int = 32, bn: int = 32) -> dict:
    """The self-draft: CSB-project every layer weight matrix of the
    target at ``prune_rate`` (Algorithm 1's two-pass row/column
    projection), each stored (in, out) leaf as it stands and in its own
    dtype. Embeddings, heads and norm scales stay intact (the same
    tensors, not copies). ``prune_rate=0`` returns ``params`` itself.

    The JAX package projects a ``w*`` leaf of rank 2 or 3 as it stacks
    it, every layer's on a leading L axis; the port's leaves inside
    ``params["layers"]`` lack that axis, so their rank counts one more.
    MoE expert stacks (E, d, ff) are rank 4 there and stay dense, as the
    router does (its name)."""
    if prune_rate <= 0.0:
        return params
    spec = CSBSpec(bm=bm, bn=bn, prune_rate=float(prune_rate))

    def one(name, leaf, stacked):
        if isinstance(leaf, dict):
            return {k: one(k, v, stacked) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [one(name, v, True) for v in leaf]
        if leaf.ndim + stacked in (2, 3) and name.startswith("w"):
            return csb_project(leaf, spec)
        return leaf

    with torch.no_grad():
        return {k: one(k, v, False) for k, v in params.items()}


def _seed(*words: int) -> int:
    """A 63-bit seed mixed from non-negative integers."""
    a, b = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return ((int(a) << 32) | int(b)) & ((1 << 63) - 1)


def _key(base: int, rid: int, index: int, purpose: int,
         device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        _seed(base, rid, index, purpose))


def _categorical(gen: torch.Generator, logits: torch.Tensor,
                 temperature: float) -> int:
    """One draw from softmax(logits / temperature): Gumbel-max over
    uniform noise from ``gen``."""
    lg = logits.to(F32) / temperature
    u = torch.rand(lg.shape, generator=gen, device=lg.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(F32).tiny)))
    return int(torch.argmax(lg + g))


def _commit_round(base: int, rid: int, p: int, drafts, q_log, pi_log,
                  k_eff: int, temperature: float) -> list[int]:
    """Rejection-sample one verify round for one sequence.

    ``drafts``: k proposed tokens (only the first ``k_eff`` are
    eligible); ``q_log``: (k, V) draft logits; ``pi_log``: (k+1, V)
    target logits, row j scoring the token at index ``p + 1 + j``.
    Returns the committed tokens — a prefix of the accepted drafts plus
    exactly one target-sampled token (correction on first rejection,
    bonus on full acceptance), so every round progresses."""
    pi_log = torch.as_tensor(pi_log)
    drafts = [int(d) for d in np.asarray(drafts).reshape(-1)]
    if temperature <= 0.0:
        tgt = torch.argmax(pi_log, dim=-1).tolist()
        out = []
        for j in range(k_eff):
            if drafts[j] != tgt[j]:
                out.append(tgt[j])               # correction
                return out
            out.append(drafts[j])
        out.append(tgt[k_eff])                   # bonus
        return out
    q_log = torch.as_tensor(q_log)
    dev = pi_log.device
    out = []
    for j in range(k_eff):
        idx = p + 1 + j
        d = drafts[j]
        pi_p = torch.softmax(pi_log[j].to(F32) / temperature, dim=-1)
        q_p = torch.softmax(q_log[j].to(F32) / temperature, dim=-1)
        u = float(torch.rand((), generator=_key(base, rid, idx, _ACCEPT,
                                                 dev), device=dev))
        ratio = float(pi_p[d]) / max(float(q_p[d]), 1e-30)
        if u < ratio:
            out.append(d)
            continue
        # first rejection: resample the residual norm(max(pi - q, 0)).
        # With a near-perfect draft the residual mass underflows — fall
        # back to pi itself (the distributions coincide there).
        res = torch.clamp(pi_p - q_p, min=0.0)
        rkey = _key(base, rid, idx, _RESID, dev)
        if float(res.sum()) < 1e-9:
            out.append(_categorical(rkey, pi_log[j], temperature))
        else:
            out.append(_categorical(rkey, torch.log(res), 1.0))
        return out
    idx = p + 1 + k_eff
    out.append(_categorical(_key(base, rid, idx, _SAMPLE, dev),
                            pi_log[k_eff], temperature))
    return out


def _propose(drf: _Runner, d_cache, cur, pos, live, rids, k: int,
             temperature: float, base: int, dev):
    """Run k+1 draft steps from frontier ``pos`` (B,) feeding ``cur``
    (B,), host arrays. Returns (proposals (k, B) int64 on the host, draft
    logits (k, B, V) on ``dev``, draft cache). The extra (k+1)-th step
    samples nothing — it writes d_k's KV into the draft cache so a fully
    accepted round (frontier jumps past the bonus token) leaves no
    unwritten position behind; after a rejection the write is stale and
    the next round overwrites it before any query attends it."""
    b = len(cur)
    drafts, q_logs = [], []
    dcur = torch.as_tensor(np.asarray(cur, np.int64), device=dev)
    for j in range(k + 1):
        posv = torch.as_tensor(np.asarray(pos, np.int64) + j, device=dev)
        lg, d_cache = drf.step(d_cache, dcur[:, None], posv)
        if j == k:
            break                      # KV catch-up write only
        ql = lg[:, -1]                 # (B, V)
        if temperature <= 0.0:
            nxt = torch.argmax(ql, dim=-1)
        else:
            nxt = torch.as_tensor([
                _categorical(_key(base, int(rids[i]), int(pos[i]) + 1 + j,
                                  _SAMPLE, dev), ql[i], temperature)
                if live[i] else 0 for i in range(b)], device=dev)
        drafts.append(nxt)
        q_logs.append(ql)
        dcur = nxt
    return (torch.stack(drafts).cpu().numpy().astype(np.int64),
            torch.stack(q_logs), d_cache)


def _check_model(cfg: ModelConfig) -> None:
    if cfg.n_codebooks:
        raise NotImplementedError(
            "speculative decoding drives single-stream token ids")
    _check_text_inputs(cfg, "speculative decoding")
    if cfg.mixer not in ("attn", "mla"):
        raise NotImplementedError(
            "speculative decoding needs a per-position KV cache "
            f"(attn/mla), not mixer={cfg.mixer!r}")


def _runners(params, cfg: ModelConfig, rate: float, dev, mesh=None,
             policy=None):
    """Target and draft runners, both on ``mesh``. The draft shares the
    target's fp32 head (the projection never touches embeddings or
    heads), and at rate 0 the target's (placed) parameters."""
    params = _to_device(params, dev)
    tgt = _Runner(params, cfg, mesh, policy)
    draft = tgt.params if rate <= 0.0 else derive_draft_params(params, rate)
    drf = _Runner(draft, cfg, mesh, policy, head=tgt.head)
    return tgt, drf


# ---------------------------------------------------------------------------
# fixed-batch speculative generate
# ---------------------------------------------------------------------------

def generate_speculative(params, cfg: ModelConfig, tokens,
                         scfg: EngineConfig,
                         generator: torch.Generator | None = None, *,
                         mesh=None, policy=None,
                         device=None) -> torch.Tensor:
    """Speculative twin of :func:`repro_torch.serve.engine.generate`:
    the same (B, S+new) output, token for token identical at temperature
    0. Contiguous caches for both models; per-row frontiers advance by
    variable acceptance, rows re-verify harmlessly once done. The first
    token is drawn from ``generator``; every later draw is keyed by
    ``generator.initial_seed()`` (0 without one). With ``mesh=`` both
    runners (target and draft) run on the mesh, as ``generate``'s does."""
    _check_model(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape[:2]
    k, max_new = scfg.spec_k, scfg.max_new_tokens
    temperature = scfg.temperature
    # + k slack: the widest verify writes p..p+k and the contiguous write
    # clamps its start instead of scattering, so the cache must hold the
    # overhang
    total = (scfg.cache_len or (s + max_new)) + k
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    base = generator.initial_seed() if generator is not None else 0
    tgt, drf = _runners(params, cfg, scfg.draft_prune_rate, dev, mesh,
                        policy)

    with torch.no_grad():
        t_log, t_cache = tgt.prefill(tokens)
        t_cache = tgt.place_cache(grow_cache(
            tgt.place_slot_cache(t_cache), total - cache_len_of(t_cache)))
        _, d_cache = drf.prefill(tokens)
        d_cache = drf.place_cache(grow_cache(
            drf.place_slot_cache(d_cache), total - cache_len_of(d_cache)))

        first = _sampler(temperature, generator)(t_log).cpu().numpy()
        out = [[int(t)] for t in first]
        pos = np.full(b, s, np.int64)
        cur = first.astype(np.int64)
        rids = np.arange(b)
        while any(len(o) < max_new for o in out):
            remaining = np.asarray([max_new - len(o) for o in out])
            live = remaining > 0
            drafts, q_logs, d_cache = _propose(
                drf, d_cache, cur, pos, live, rids, k, temperature, base,
                dev)
            verify = np.concatenate([cur[:, None], drafts.T], axis=1)
            pi, t_cache = tgt.step(t_cache,
                                   torch.as_tensor(verify, device=dev),
                                   torch.as_tensor(pos, device=dev))
            for i in range(b):
                if not live[i]:
                    continue
                k_eff = min(k, int(remaining[i]) - 1)
                committed = _commit_round(base, int(rids[i]), int(pos[i]),
                                          drafts[:, i], q_logs[:, i],
                                          pi[i], k_eff, temperature)
                out[i].extend(committed)
                pos[i] += len(committed)
                cur[i] = committed[-1]
    gen = torch.as_tensor([o[:max_new] for o in out], device=dev)
    return torch.cat([tokens, gen], dim=1)


def _spec_stats(scfg: EngineConfig, rounds: int, proposed: int,
                accepted: int) -> dict:
    return {
        "spec_k": scfg.spec_k,
        "draft_prune_rate": scfg.draft_prune_rate,
        "rounds": rounds,
        "proposed": proposed,
        "accepted": accepted,
        "acceptance_rate": round(accepted / proposed, 4) if proposed
        else 1.0,
    }


# ---------------------------------------------------------------------------
# continuous-batching speculative serve
# ---------------------------------------------------------------------------

def serve_continuous_speculative(params, cfg: ModelConfig, requests,
                                 config: EngineConfig, *, mesh=None,
                                 policy=None,
                                 generator: torch.Generator | None = None,
                                 device=None) -> ServeResult:
    """Speculative twin of ``serve_continuous`` (dispatched from there
    when ``config.speculative``). Paged target cache + contiguous draft
    cache; admission, bucketing and eviction mirror the plain engine so
    temperature-0 tokens are identical to it. Requires ``paged=True``:
    per-slot variable acceptance is a page-table rollback
    (``PagePool.truncate``). The verify step carries k+1 queries, so it
    takes the gather path even with ``use_kernel=True``. With ``mesh=``
    both runners run on the mesh, as ``serve_continuous``'s does."""
    _check_model(cfg)
    if not config.paged:
        raise ValueError("speculative serve_continuous requires "
                         "config.paged=True (rollback is a page-table "
                         "truncate)")
    dev = resolve_device(device)
    n_slots, k = config.n_slots, config.spec_k
    temperature = config.temperature
    page_size, pool_pages = config.page_size, config.pool_pages
    use_kernel = config.use_kernel
    bucket = (config.bucket_prompts if config.bucket_prompts is not None
              else True)
    if not requests:
        stats = SlotScheduler(n_slots).stats()
        stats.update(cache_len=0, tokens_per_sec=0.0, paged=True,
                     bucketed_prefill=bucket, prefix_cache=False,
                     prefill_tokens=0, compile_time_s=0.0,
                     steady_tokens_per_sec=0.0,
                     sharded=_resolve_mesh(mesh) is not None,
                     speculative=_spec_stats(config, 0, 0, 0))
        stats["paging"] = PagePool(
            page_size, 1 if pool_pages is None else pool_pages,
            n_slots, 1, device=dev).summary()
        stats["page_stalls"] = 0
        return ServeResult({}, stats, 0.0)

    cache_len = config.cache_len or max(
        r.prompt_len + r.max_new_tokens for r in requests)
    short = [r for r in requests
             if r.prompt_len + r.max_new_tokens > cache_len]
    if short:
        raise ValueError(
            f"cache_len={cache_len} cannot hold request(s) "
            f"{[r.rid for r in short]}")

    tgt, drf = _runners(params, cfg, config.draft_prune_rate, dev, mesh,
                        policy)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(temperature, generator)
    # decode draws come from a FIXED base: how many admissions precede a
    # given round depends on spec_k, so nothing drawn at admission may
    # feed the decode keys
    base = _seed(generator.initial_seed() if generator is not None else 0,
                 _SERVE_SALT)

    # the verify step writes up to k positions past a slot's committed
    # frontier: widen the page-table logical width so those positions
    # map to real table entries (unmapped -> scratch) instead of
    # clipping back into the slot's last mapped page
    max_pages = pages_for(cache_len + k, page_size)
    n_pool = n_slots * max_pages if pool_pages is None else pool_pages
    pool = PagePool(page_size, n_pool, n_slots, max_pages, device=dev)
    sched = SlotScheduler(n_slots, pool=pool)
    for r in requests:
        sched.submit(r)

    dtype = getattr(torch, cfg.dtype)
    t_cache = tgt.place_cache(LM.init_paged_cache(
        cfg, pool.n_pages, page_size, n_slots, dtype, dev), paged=True)
    # contiguous draft cache, + k slack for the round's proposal writes
    d_cache = drf.place_cache(LM.init_cache(cfg, n_slots, cache_len + k,
                                            dtype, dev))
    cur = np.zeros(n_slots, np.int64)
    rid_of = np.zeros(n_slots, np.int64)
    tr = obs_trace.get()
    reg = obs_metrics.get()
    prefill_tokens = 0
    compile_ns = steady_ns = steady_tokens = 0
    proposed = accepted = rounds = 0

    t0 = time.perf_counter()
    with torch.no_grad():
        while sched.has_work():
            for slot, req in sched.admit():
                toks = np.asarray(req.tokens)
                plen = req.prompt_len
                t_pf = time.perf_counter_ns()
                if bucket:
                    padded = torch.as_tensor(np.pad(
                        toks, [(0, bucket_len(plen) - plen)]),
                        device=dev)[None]
                    logits, req_cache = tgt.prefill(padded,
                                                    last_pos=plen - 1)
                    _, d_req = drf.prefill(padded, last_pos=plen - 1)
                    prefill_tokens += int(padded.shape[1])
                else:
                    t_toks = torch.as_tensor(toks, device=dev)[None]
                    logits, req_cache = tgt.prefill(t_toks)
                    _, d_req = drf.prefill(t_toks)
                    prefill_tokens += plen
                first = int(sample(logits).reshape(-1)[0])
                if tgt.last_cold:
                    compile_ns += time.perf_counter_ns() - t_pf
                if sched.started(slot, first):
                    t_cache = _insert_prefilled(
                        t_cache, pool, slot, tgt.place_slot_cache(req_cache),
                        toks)
                    d_cache = insert_slot_cache(
                        d_cache, fit_cache_len(drf.place_slot_cache(d_req),
                                               plen), slot)
                    cur[slot] = first
                    rid_of[slot] = req.rid
            active = sched.active_mask()
            if not active.any():
                sched.idle_tick()
                continue
            pos_host = sched.positions().astype(np.int64)
            remaining = np.asarray([
                0 if s is None else s.remaining for s in sched._slots])
            t_st = time.perf_counter_ns()
            drafts, q_logs, d_cache = _propose(
                drf, d_cache, cur, pos_host, active, rid_of, k,
                temperature, base, dev)
            # map pages for every position this round's verify writes,
            # capped at the slot's lifetime token count (overhang
            # positions past the cap land on scratch / the masked
            # boundary page)
            for i in np.flatnonzero(active):
                pool.ensure(int(i), int(min(pos_host[i] + k + 1,
                                            pos_host[i] + remaining[i])))
            pool.tick()
            verify = np.concatenate([cur[:, None], drafts.T], axis=1)
            pi, t_cache = tgt.step_paged(
                t_cache, torch.as_tensor(verify, device=dev),
                torch.as_tensor(pos_host, device=dev), pool.device_table(),
                use_kernel=use_kernel)
            rounds += 1
            committed: dict[int, list[int]] = {}
            for i in np.flatnonzero(active):
                k_eff = min(k, int(remaining[i]) - 1)
                toks = _commit_round(base, int(rid_of[i]),
                                     int(pos_host[i]), drafts[:, i],
                                     q_logs[:, i], pi[i], k_eff,
                                     temperature)
                committed[int(i)] = toks
                proposed += k_eff
                accepted += len(toks) - 1
                # roll the page table back past the last committed write
                pool.truncate(int(i), int(pos_host[i]) + len(toks))
                cur[i] = toks[-1]
            t_en = time.perf_counter_ns()
            n_committed = sum(len(t) for t in committed.values())
            if tgt.last_cold or drf.last_cold:
                compile_ns += t_en - t_st
            else:
                steady_ns += t_en - t_st
                steady_tokens += n_committed
            if tr is not None:
                tr.complete("serve/spec_round", t_st, t_en - t_st,
                            track="engine",
                            args={"committed": n_committed,
                                  "active": int(active.sum())})
            if reg is not None:
                reg.histogram("serve/spec/tokens_per_round").observe(
                    n_committed)
            for slot in sched.advance_spec(committed):
                t_cache = evict_slot_state(t_cache, slot)
                d_cache = evict_slot(d_cache, slot)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    stats = sched.stats()
    stats["cache_len"] = cache_len
    stats["paged"] = True
    stats["bucketed_prefill"] = bucket
    stats["prefix_cache"] = False
    stats["prefill_tokens"] = prefill_tokens
    stats["tokens_per_sec"] = round(
        stats["generated_tokens"] / wall, 3) if wall > 0 else 0.0
    stats["compile_time_s"] = round(compile_ns / 1e9, 6)
    stats["steady_tokens_per_sec"] = round(
        steady_tokens / (steady_ns / 1e9), 3) if steady_ns > 0 else 0.0
    stats["sharded"] = tgt.mesh is not None
    stats["speculative"] = _spec_stats(config, rounds, proposed, accepted)
    stats["paging"] = pool.summary()
    return ServeResult(sched.results, stats, wall)


__all__ = ["derive_draft_params", "generate_speculative",
           "serve_continuous_speculative"]
