"""Continuous-batching scheduler: request slots, admission, per-slot cache.

The serve engine holds a fixed batch of ``n_slots`` decode *slots*;
requests flow through slots continuously — a finished request frees its
slot mid-decode and the next queued prompt is prefilled straight into
it, the way the paper's CSB engine keeps every PEGroup busy by
re-balancing block work (§5.2) — here the balancing unit is a whole
request.

A port of ``repro.serve.scheduler``:

* :class:`SlotScheduler`, :class:`Request` and :func:`simulate_admission`
  are host bookkeeping, copied unchanged: the scheduler never touches a
  device array.
* :func:`cache_len_of`, :func:`grow_cache` and :func:`fit_cache_len` are
  the cache time-dim helpers, on dicts of tensors.
* :func:`insert_paged_cache` and :func:`evict_slot_state` are the device
  half of the paged path. They write the batch cache in place and return
  it (JAX's donated jit returns a new tree), which saves a copy of the
  whole pool per admission and eviction.

The contiguous-cache helpers (``insert_slot_cache``, ``evict_slot``) and
the prefix-cache helpers (``insert_paged_span``, ``copy_page_cache``)
wait for the slices that port the contiguous engine and the prefix
cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

# cache leaves carrying a (L, B, T, ...) time dimension at axis 2
_TIME_KEYS = ("k", "v", "c_kv", "k_rope")


def _map(cache: dict, fn) -> dict:
    """A new nested dict with ``fn(key, leaf)`` applied to every leaf."""
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(k, v))
            for k, v in cache.items()}


def _leaves(cache: dict):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


# ---------------------------------------------------------------------------
# cache time-dim helpers
# ---------------------------------------------------------------------------

def cache_len_of(cache: dict) -> int:
    """Time capacity T of a decode cache (0 for empty / pure-state
    caches, whose leaves carry no time dim)."""
    for key, leaf in _leaves(cache):
        if key in ("k", "v", "c_kv"):
            return leaf.shape[2]   # (L, B, T, ...)
    return 0


def grow_cache(cache: dict, extra: int) -> dict:
    """Pad every time-keyed leaf by ``extra`` zeros along its time dim.
    No-op for ``extra <= 0`` and for leaves without a time dim."""
    if extra <= 0:
        return cache

    def grow(key, leaf):
        if key in _TIME_KEYS and leaf.ndim >= 3:
            pad = [0, 0] * (leaf.ndim - 3) + [0, extra]
            return F.pad(leaf, pad)
        return leaf

    return _map(cache, grow)


def fit_cache_len(cache: dict, t: int) -> dict:
    """Grow or truncate every time-keyed leaf to exactly ``t`` time
    positions (the paged insert needs a whole number of pages)."""
    cur = cache_len_of(cache)
    if cur < t:
        return grow_cache(cache, t - cur)
    if cur == t:
        return cache

    def cut(key, leaf):
        if key in _TIME_KEYS and leaf.ndim >= 3:
            return leaf[:, :, :t]
        return leaf

    return _map(cache, cut)


# ---------------------------------------------------------------------------
# paged-cache slot ops (device side; serve.paging owns the page table)
# ---------------------------------------------------------------------------

def _pairs(batch_cache: dict, slot_cache: dict):
    for k, b in batch_cache.items():
        if isinstance(b, dict):
            yield from _pairs(b, slot_cache[k])
        else:
            yield k, b, slot_cache[k]


def insert_paged_cache(batch_cache: dict, slot_cache: dict, phys_pages,
                       slot: int) -> dict:
    """Write a prefilled single-request cache into the paged batch cache,
    in place; returns ``batch_cache``.

    Time-keyed leaves of ``slot_cache`` must span exactly
    ``len(phys_pages) * page_size`` positions (``fit_cache_len``); each
    logical page i lands in physical page ``phys_pages[i]`` across all
    layers at once. Pages are fully overwritten, so a recycled page
    carries nothing of its previous tenant below the decode position.
    Pad entries of ``phys_pages`` name the scratch page; which of them
    lands there last is unspecified on the card, and nothing reads the
    scratch page unmasked. State leaves write into batch slot ``slot``.
    """
    for key, b, u in _pairs(batch_cache, slot_cache):
        if key in _TIME_KEYS and u.ndim >= 3:
            # b: (L, N_pool, P, ...) pool; u: (L, 1, n*P, ...) request
            l, psz = b.shape[0], b.shape[2]
            phys = torch.as_tensor(np.asarray(phys_pages, np.int64),
                                   device=b.device)
            pages = u[:, 0].reshape((l, phys.shape[0], psz)
                                    + tuple(u.shape[3:]))
            b[:, phys] = pages.to(b.dtype)
        else:
            b[:, slot] = u[:, 0].to(b.dtype)
    return batch_cache


def evict_slot_state(batch_cache: dict, slot: int) -> dict:
    """Paged eviction, in place: zero only the per-slot state leaves
    (recurrent mixers' state carries no position mask). The KV pages
    just return to the allocator's free list; the decode mask plus
    page-granular overwrite keeps them unleakable without a device-side
    zero (serve.paging module docstring). Returns ``batch_cache``."""
    for key, b in _leaves(batch_cache):
        if key not in _TIME_KEYS:
            b[:, slot] = 0
    return batch_cache


# ---------------------------------------------------------------------------
# host-side scheduling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request.

    ``arrival`` is measured in decode steps: the request may not be
    admitted before the engine's clock reaches it (the mixed-length
    prompts-arriving-over-time workload).

    ``deadline_us`` is optional SLO metadata (None: no deadline): the
    wall-time budget from arrival to last token. The scheduler only
    records it — :meth:`SlotScheduler.slo_report` (and through it
    :func:`simulate_admission` / the serve router) converts the step
    clock into microseconds under a per-step cost model and reports
    attainment against it.
    """

    rid: int
    tokens: Any                       # (S,) or (S, K) prompt token ids
    max_new_tokens: int = 32
    arrival: int = 0
    deadline_us: float | None = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[0])


@dataclasses.dataclass
class _Slot:
    rid: int
    pos: int                          # next cache write position
    remaining: int
    generated: list = dataclasses.field(default_factory=list)


class SlotScheduler:
    """Admission + slot bookkeeping. Drives nothing itself — the engine
    (or :func:`simulate_admission`) owns the loop and tells the
    scheduler what happened.

    With a :class:`repro_torch.serve.paging.PagePool` attached, admission is
    **by free pages, not free slots**: a free slot only takes a request
    when the pool can reserve its worst-case page count, and a finished
    request's pages return to the pool inside :meth:`_finish` (so
    scheduler and allocator can never disagree about liveness — the
    fuzz suite leans on this). The engine still owns physical page
    growth (``pool.ensure``) because only it knows when device writes
    happen.
    """

    def __init__(self, n_slots: int, pool=None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.pool = pool
        self.now = 0                  # decode-step clock
        self._pending: list[Request] = []
        self._slots: list[_Slot | None] = [None] * n_slots
        self.results: dict[int, list[int]] = {}
        self.prefills = 0
        self.decode_steps = 0
        self.idle_steps = 0
        self.active_slot_steps = 0
        self.peak_active = 0
        self.page_stalls = 0          # admissions deferred for pages
        self.prefix_hits = 0          # admissions that matched the trie
        self.shared_pages = 0         # pages mapped shared across them
        # per-request lifecycle in step time: arrival/admit/finish steps
        # + the request's deadline — the raw material of slo_report()
        self.req_log: dict[int, dict] = {}

    # -- submission / admission --------------------------------------------
    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.pool is not None and not self.pool.fits_ever(
                req.prompt_len + req.max_new_tokens):
            raise ValueError(
                f"request {req.rid} needs "
                f"{self.pool.pages_needed(req.prompt_len + req.max_new_tokens)}"
                f" pages and can never fit the pool "
                f"({self.pool.n_pages} pages, {self.pool.max_pages}/slot)")
        self._pending.append(req)
        self._pending.sort(key=lambda r: (r.arrival, r.rid))
        self.req_log[req.rid] = {"arrival": req.arrival,
                                 "deadline_us": req.deadline_us}

    def has_work(self) -> bool:
        return bool(self._pending) or any(
            s is not None for s in self._slots)

    def admit(self, limit: int | None = None) -> list[tuple[int, Request]]:
        """Fill free slots with arrived requests (FIFO by arrival).
        The engine must prefill each returned request and then call
        :meth:`started` with the token its prefill produced.

        Paged: the FIFO head must fit the pool's available pages or
        admission stops for this step (strict FIFO — no later request
        jumps a starved head, so admission order stays deterministic and
        starvation-free; pages drain back as running requests finish).

        ``limit`` caps the admissions per call — the prefix-cache engine
        admits one at a time so each prompt is registered before the
        next admission's trie match runs (same-step sharing)."""
        out = []
        for i in range(self.n_slots):
            if limit is not None and len(out) >= limit:
                break
            if self._slots[i] is not None:
                continue
            req = next((r for r in self._pending if r.arrival <= self.now),
                       None)
            if req is None:
                break
            total = req.prompt_len + req.max_new_tokens
            if self.pool is not None:
                if getattr(self.pool, "prefix_cache", False):
                    toks = np.asarray(req.tokens).reshape(-1)
                    info = self.pool.try_reserve(i, total, tokens=toks)
                    if info is None:
                        self.page_stalls += 1
                        self._emit_stall(req)
                        break
                    if info.shared_pages:
                        self.prefix_hits += 1
                        self.shared_pages += info.shared_pages
                else:
                    if not self.pool.can_admit(total):
                        self.page_stalls += 1
                        self._emit_stall(req)
                        break
                    self.pool.reserve(i, total)
            self._pending.remove(req)
            self._slots[i] = _Slot(rid=req.rid, pos=req.prompt_len,
                                   remaining=req.max_new_tokens)
            self.req_log[req.rid]["admit_step"] = self.now
            out.append((i, req))
            obs_trace.instant("serve/sched/admit",
                              args={"rid": req.rid, "slot": i,
                                    "step": self.now})
            reg = obs_metrics.get()
            if reg is not None:
                reg.counter("serve/sched/admitted").inc()
        self.peak_active = max(self.peak_active, sum(
            s is not None for s in self._slots))
        return out

    def _emit_stall(self, req: Request) -> None:
        """Observability: an admission deferred for pages (outcome
        timeline, not just the final page_stalls count)."""
        obs_trace.instant("serve/sched/page_stall",
                          args={"rid": req.rid, "step": self.now})
        reg = obs_metrics.get()
        if reg is not None:
            reg.counter("serve/sched/page_stalls").inc()

    def arrived_pending(self) -> list[int]:
        """rids of queued requests whose arrival step has been reached
        (admissible now, waiting for a slot/pages) — the set whose
        queue-wait clock is running."""
        return [r.rid for r in self._pending if r.arrival <= self.now]

    def slot_rids(self) -> list[int | None]:
        """Per-slot resident rid (None for free slots)."""
        return [None if s is None else s.rid for s in self._slots]

    def started(self, slot: int, first_token: int) -> bool:
        """Record the prefill-sampled first token. Returns False when
        the request is already complete (max_new_tokens == 1) — the
        engine should evict the slot without decoding it."""
        s = self._slots[slot]
        assert s is not None, "started() on a free slot"
        self.prefills += 1
        s.generated.append(int(first_token))
        s.remaining -= 1
        if s.remaining == 0:
            self._finish(slot)
            return False
        return True

    # -- per-step state the engine feeds the jitted decode ------------------
    def active_mask(self) -> np.ndarray:
        return np.asarray([s is not None for s in self._slots], bool)

    def positions(self) -> np.ndarray:
        """(n_slots,) int32 cache positions; free slots report 0."""
        return np.asarray([0 if s is None else s.pos
                           for s in self._slots], np.int32)

    def advance(self, sampled: np.ndarray) -> list[int]:
        """One decode step ran over the whole batch. ``sampled[i]`` is
        slot i's next token (ignored for free slots). Returns the slots
        freed this step (engine evicts + refills them)."""
        self.now += 1
        self.decode_steps += 1
        freed = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            self.active_slot_steps += 1
            s.generated.append(int(np.asarray(sampled[i]).reshape(-1)[0]))
            s.pos += 1
            s.remaining -= 1
            if s.remaining == 0:
                self._finish(i)
                freed.append(i)
        return freed

    def advance_spec(self, committed: dict[int, list[int]]) -> list[int]:
        """One speculative round ran. ``committed[i]`` is the list of
        tokens the rejection sampler committed for slot i this round
        (1..k+1 tokens — every round makes progress). Slots absent from
        ``committed`` were idle this round. Returns freed slots."""
        self.now += 1
        self.decode_steps += 1
        freed = []
        for i, toks in committed.items():
            s = self._slots[i]
            assert s is not None, f"advance_spec on free slot {i}"
            assert 1 <= len(toks) <= s.remaining, \
                f"slot {i}: committed {len(toks)} with {s.remaining} left"
            self.active_slot_steps += 1
            s.generated.extend(int(t) for t in toks)
            s.pos += len(toks)
            s.remaining -= len(toks)
            if s.remaining == 0:
                self._finish(i)
                freed.append(i)
        return freed

    def idle_tick(self) -> None:
        """Nothing active and nothing arrived: jump the clock to the
        next arrival instead of burning empty decode steps."""
        nxt = min((r.arrival for r in self._pending), default=self.now + 1)
        self.idle_steps += max(nxt - self.now, 1)
        self.now = max(nxt, self.now + 1)

    def _finish(self, slot: int) -> None:
        s = self._slots[slot]
        self.results[s.rid] = s.generated
        self.req_log[s.rid]["finish_step"] = self.now
        self._slots[slot] = None
        if self.pool is not None:
            self.pool.release(slot)

    # -- reporting -----------------------------------------------------------
    def occupancy(self) -> float:
        """Achieved slot occupancy over decode steps: 1.0 means every
        slot held a live request on every step the batch decoded."""
        total = self.decode_steps * self.n_slots
        return self.active_slot_steps / total if total else 0.0

    def slo_report(self, step_time_us: float) -> dict:
        """Per-request TTFT/latency percentiles + SLO attainment under
        a per-step cost model (``step_time_us`` per decode step — the
        dryrun feeds its roofline step time here, tests feed 1.0).

        Step accounting: the prefill that produces the first token runs
        inside the admit step, so ``ttft = admit - arrival + 1`` steps
        and ``latency = finish - arrival + 1`` (a prefill-only request
        costs exactly one step). Attainment counts only requests that
        carry a ``deadline_us`` (None when no request does).
        """
        ttft, lat, per_req = [], [], {}
        met = deadlines = 0
        for rid, log in sorted(self.req_log.items()):
            if "admit_step" not in log or "finish_step" not in log:
                continue                       # still pending/active
            t = (log["admit_step"] - log["arrival"] + 1) * step_time_us
            lt = (log["finish_step"] - log["arrival"] + 1) * step_time_us
            ttft.append(t)
            lat.append(lt)
            ok = None
            if log["deadline_us"] is not None:
                deadlines += 1
                ok = bool(lt <= log["deadline_us"])
                met += ok
            per_req[rid] = {"ttft_us": round(t, 3),
                            "latency_us": round(lt, 3), "met": ok}

        def pct(a, q):
            return round(float(np.percentile(a, q)), 3) if a else 0.0

        return {
            "step_time_us": step_time_us,
            "requests": len(lat),
            "ttft_us": {"p50": pct(ttft, 50), "p99": pct(ttft, 99)},
            "latency_us": {"p50": pct(lat, 50), "p99": pct(lat, 99)},
            "deadlines": deadlines,
            "attainment": (round(met / deadlines, 4)
                           if deadlines else None),
            "per_request": per_req,
        }

    def stats(self) -> dict:
        out = {
            "slots": self.n_slots,
            "requests": len(self.results),
            "generated_tokens": sum(len(v) for v in self.results.values()),
            "prefills": self.prefills,
            "decode_steps": self.decode_steps,
            "idle_steps": self.idle_steps,
            "peak_active": self.peak_active,
            "occupancy": round(self.occupancy(), 4),
            # the step clock when the last request finished — the
            # makespan the router's load-aware projection minimizes
            "final_step": self.now,
        }
        if self.pool is not None:
            out["page_stalls"] = self.page_stalls
            if getattr(self.pool, "prefix_cache", False):
                out["prefix_hits"] = self.prefix_hits
                out["shared_pages"] = self.shared_pages
            out["paging"] = self.pool.summary()
        return out


def simulate_admission(n_slots: int, requests: list[Request],
                       pool=None, step_time_us: float | None = None
                       ) -> dict:
    """Modelless replay of the admission policy: how well do ``n_slots``
    stay occupied for this trace? Used by launch/dryrun.py to record the
    achieved occupancy a decode cell's slot count implies, by the serve
    router's load-aware placement, and by tests (no devices, no model —
    pure host bookkeeping).

    With a ``pool`` (:class:`repro_torch.serve.paging.PagePool`) the replay
    also drives page reservation/growth/release exactly as the engine
    would, so the returned stats carry page occupancy and internal
    fragmentation for the trace — the dryrun ``serve.paged`` record.

    With ``step_time_us`` (a per-step cost model, e.g. the dryrun's
    roofline step time) the stats gain a ``"slo"`` record: per-request
    TTFT/latency percentiles and deadline attainment
    (:meth:`SlotScheduler.slo_report`).
    """
    sched = SlotScheduler(n_slots, pool=pool)
    for r in requests:
        sched.submit(r)
    guard = sum(r.max_new_tokens for r in requests) + sum(
        r.arrival for r in requests) + len(requests) + 1
    while sched.has_work():
        for slot, req in sched.admit():
            if pool is not None:
                pool.cow_if_needed(slot)
                pool.ensure(slot, req.prompt_len)
                pool.register_prefix(slot,
                                     np.asarray(req.tokens).reshape(-1))
            sched.started(slot, 0)
        if not sched.active_mask().any():
            sched.idle_tick()
            continue
        if pool is not None:
            active = sched.active_mask()
            pos = sched.positions()
            for i in range(n_slots):
                if active[i]:
                    pool.ensure(i, int(pos[i]) + 1)
            pool.tick()
        sched.advance(np.zeros(n_slots, np.int64))
        guard -= 1
        if guard < 0:  # pragma: no cover - scheduler invariant broken
            raise RuntimeError("simulate_admission did not terminate")
    stats = sched.stats()
    if step_time_us is not None:
        stats["slo"] = sched.slo_report(step_time_us)
    return stats


__all__ = [
    "Request", "SlotScheduler", "simulate_admission",
    "cache_len_of", "fit_cache_len", "grow_cache",
    "insert_paged_cache", "evict_slot_state",
]
