"""Serving engines, ported from ``repro.serve.engine``.

``serve_continuous`` — the production shape for decoder LMs: a fixed
batch of decode *slots* fed by :class:`SlotScheduler`. Requests with
mixed prompt lengths arrive over time; a finished request's slot is
evicted and the next queued prompt prefilled into it mid-decode. This
slice ports the paged path (``paged=True``): the slots share the
``serve.paging`` block pool (admission by free pages, page-table decode,
pow2 prompt-bucketed prefill), and ``use_kernel=True`` runs decode
attention through the paged-attention CUDA kernel.

``rnn_serve_frames`` — the paper's own serving shape: frame-by-frame RNN
inference (one MVM-bound cell step per frame) with CSB-compressed
weights; it returns per-frame outputs and the wall-clock time per frame,
so the faster-than-realtime criterion (<500 us/frame for speech) can be
checked on the card.

The mesh-sharded variants wait for the port of the multi-device layer.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.cells import CellGraph, cell_apply, init_state
from repro_torch.models import ModelConfig
from repro_torch.models import lm as LM
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

from .config import EngineConfig, resolve_config
from .paging import PagePool, pages_for
from .scheduler import (
    Request, SlotScheduler, evict_slot_state, fit_cache_len,
    insert_paged_cache,
)


def bucket_len(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the prefill-shape bucket.

    Padding prompts up to pow2 buckets bounds the number of distinct
    prefill shapes at O(log max_len) for arbitrary length traces (the
    floor merges the tiny lengths into one bucket)."""
    return 1 << max(max(n, floor) - 1, 0).bit_length()


class _Runner:
    """One (params, cfg) serving context on one device: holds the
    parameters, one fp32 copy of the head for the logits product (so
    that a low-precision model does not cast its (d, V) head on every
    step), and the cold-call bookkeeping.

    ``last_cold`` is True when the preceding prefill/step call was the
    first with its shape key (prefill length; decode-step variant): that
    call pays the one-time costs (the kernel library's load, the math
    libraries' workspaces), and the engine charges its wall time to
    ``compile_time_s`` instead of the steady-state throughput."""

    def __init__(self, params, cfg: ModelConfig):
        self.cfg = cfg
        self.params = params
        self.head = LM.head_f32(params, cfg)
        self.last_cold = False
        self._seen_keys: set = set()

    def _call_cold(self, key, call):
        out = call()
        self.last_cold = key not in self._seen_keys
        self._seen_keys.add(key)
        return out

    def prefill(self, tokens: torch.Tensor, last_pos=None):
        key = ("prefill", tuple(tokens.shape), last_pos is not None)
        return self._call_cold(key, lambda: LM.prefill(
            self.params, {"tokens": tokens}, self.cfg, last_pos=last_pos,
            head=self.head))

    def step_paged(self, cache, tokens, pos, page_table,
                   use_kernel: bool = False):
        key = ("paged", pos.ndim, use_kernel)
        return self._call_cold(key, lambda: LM.decode_step_paged(
            self.params, cache, tokens, pos, page_table, self.cfg,
            use_kernel=use_kernel, head=self.head))


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


def serve_continuous(params, cfg: ModelConfig, requests: list[Request],
                     config: EngineConfig | None = None, *, mesh=None,
                     generator: torch.Generator | None = None,
                     device=None) -> ServeResult:
    """Serve ``requests`` (mixed prompt lengths, arriving over time)
    through ``config.n_slots`` continuously-batched decode slots backed
    by the paged KV pool (``config.paged`` must be True).

    Parameters (as ``models.lm.init_params`` or
    ``convert.lm_params_from_numpy`` make them) move to ``device``
    (``None`` means the card; a no-op where they already lie there).
    Each decode step runs every slot at its own position; admission
    prefills each arrived prompt and writes its cache into the freed
    slot's pages. Greedy decoding (``temperature=0``) gives the JAX
    package's tokens.

    ``paged=True`` backs the slots with a shared pool of ``pool_pages``
    fixed-size token pages (``page_size`` each; default pool = the full
    contiguous capacity). Slots map logical positions to physical pages
    through a dense page table (``serve.paging``); admission goes **by
    free pages, not free slots**, each request reserving only its own
    worst case. Pages free mid-decode the moment a request finishes.

    ``use_kernel=True`` routes decode attention through the
    paged-attention kernel (``kernels.paged_attn_decode``): the page-table
    walk happens inside the kernel instead of a materialized
    ``(B, max_pages*P)`` gather; sampled tokens are unchanged.

    ``bucket_prompts`` (default: on when paged) right-pads each prompt to
    a pow2 **bucket** before prefill. Causal attention makes right
    padding invisible to real positions, so sampled tokens are
    unchanged.

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

    Not in this slice (each raises ``NotImplementedError``): the
    contiguous cache (``paged=False``) and ``prefix_cache=True`` come
    with the port's next serve slices, ``speculative=True`` with the
    CSB-pruned draft, and ``mesh=`` with the multi-GPU slice.
    """
    if cfg.n_codebooks:
        raise NotImplementedError(
            "serve_continuous drives single-stream token ids; codebook "
            "models go through generate()")
    config = resolve_config(config, caller="serve_continuous")
    if mesh is not None:
        raise NotImplementedError(
            "serve_continuous(mesh=...) waits for the multi-GPU slice of "
            "the port")
    if config.speculative:
        raise NotImplementedError(
            "speculative=True waits for the port's speculative-decoding "
            "slice (the CSB-pruned draft through the CSB-MVM kernel)")
    if not config.paged:
        raise NotImplementedError(
            "paged=False (the contiguous cache) waits for the port's "
            "generate()/contiguous-cache slice; pass paged=True")
    if config.prefix_cache:
        raise NotImplementedError(
            "prefix_cache=True waits for the port's prefix-cache slice")
    dev = resolve_device(device)
    n_slots, temperature = config.n_slots, config.temperature
    cache_len = config.cache_len
    page_size, pool_pages = config.page_size, config.pool_pages
    use_kernel = config.use_kernel
    bucket = (config.bucket_prompts if config.bucket_prompts is not None
              else True)
    bucket = bucket and cfg.mixer in ("attn", "mla")
    if not requests:
        stats = SlotScheduler(n_slots).stats()
        stats.update(cache_len=0, tokens_per_sec=0.0, paged=True,
                     bucketed_prefill=bucket, prefix_cache=False,
                     prefill_tokens=0, compile_time_s=0.0,
                     steady_tokens_per_sec=0.0, sharded=False)
        stats["paging"] = PagePool(
            page_size, 1 if pool_pages is None else pool_pages, n_slots, 1,
            device=dev).summary()
        stats["page_stalls"] = 0
        return ServeResult({}, stats, 0.0)
    cache_len = cache_len or max(
        r.prompt_len + r.max_new_tokens for r in requests)
    short = [r for r in requests
             if r.prompt_len + r.max_new_tokens > cache_len]
    if short:
        raise ValueError(
            f"cache_len={cache_len} cannot hold request(s) "
            f"{[r.rid for r in short]}")

    params = _to_device(params, dev)
    runner = _Runner(params, cfg)
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    sample = _sampler(temperature, generator)

    max_pages = pages_for(cache_len, page_size)
    # explicit pool_pages=0 must reject (PagePool raises), not silently
    # fall back to the full contiguous footprint
    n_pool = n_slots * max_pages if pool_pages is None else pool_pages
    pool = PagePool(page_size, n_pool, n_slots, max_pages, device=dev)
    sched = SlotScheduler(n_slots, pool=pool)
    for r in requests:
        sched.submit(r)

    cache = LM.init_paged_cache(cfg, pool.n_pages, page_size, n_slots,
                                getattr(torch, cfg.dtype), dev)
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
            for slot, req in sched.admit():
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
                if bucket:
                    padded = np.pad(tokens, [(0, bucket_len(plen) - plen)])
                    logits, req_cache = runner.prefill(
                        torch.as_tensor(padded, device=dev)[None],
                        last_pos=plen - 1)
                    prefill_tokens += int(padded.shape[0])
                else:
                    logits, req_cache = runner.prefill(
                        torch.as_tensor(tokens, device=dev)[None])
                    prefill_tokens += plen
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
                                          "shared": False,
                                          "cold": runner.last_cold})
                        tr.complete("serve/req/ttft", t_el, t_ft - t_el,
                                    track=track, args={"rid": req.rid})
                    if reg is not None:
                        reg.histogram("serve/req/prefill_us").observe(
                            (t_ft - t_pf) / 1e3)
                        reg.histogram("serve/req/ttft_us").observe(
                            (t_ft - t_el) / 1e3)
                if sched.started(slot, first):
                    pool.ensure(slot, plen)
                    phys = list(pool.slot_pages(slot))
                    # pad the page list to a pow2 count with the scratch
                    # page, as the JAX engine does to bound its compiled
                    # insert variants (the scratch page swallows the pad)
                    n_pad = 1 << max(len(phys) - 1, 0).bit_length()
                    phys += [pool.scratch_page] * (n_pad - len(phys))
                    req_cache = fit_cache_len(req_cache,
                                              len(phys) * page_size)
                    cache = insert_paged_cache(cache, req_cache, phys, slot)
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
            pos = torch.as_tensor(pos_host, device=dev)
            # alloc-on-grow: map the page each live slot writes this step
            for i in np.flatnonzero(active):
                pool.ensure(int(i), int(pos_host[i]) + 1)
            pool.tick()
            lg, cache = runner.step_paged(cache, cur, pos,
                                          pool.device_table(),
                                          use_kernel=use_kernel)
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
                # pages went back to the allocator inside the scheduler;
                # per-slot recurrent state still needs the device zero
                cache = evict_slot_state(cache, slot)
                if obs_on:
                    _finish_req(rid_by_slot[slot], time.perf_counter_ns())
            cur = nxt[:, None].to(torch.int32)
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
    stats["sharded"] = False
    return ServeResult(sched.results, stats, wall)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree.to(dev)


def rnn_serve_frames(graph: CellGraph, params: dict, frames,
                     state: dict | None = None,
                     warmup: int | None = None,
                     *, config: EngineConfig | None = None, mesh=None,
                     collect_frame_times: bool | None = None,
                     device=None):
    """frames: (T, B, in_dim) tensor or array. Weights may be dense
    tensors or ``PaddedCSB``; they, the frames and ``state`` are moved to
    ``device`` (``None`` means the card).

    ``config.frame_warmup`` / ``config.collect_frame_times`` are the
    :class:`EngineConfig` homes of the two knobs; the positional
    ``warmup`` and ``collect_frame_times`` arguments override them when
    given explicitly.

    Returns (outputs (T,B,H), final state, us_per_frame). ``us_per_frame``
    comes from an unblocked pass over all frames that synchronises the
    device once, at its end: the throughput number.

    ``collect_frame_times=True`` appends a 4th element: a ``(T,)`` numpy
    array of per-frame wall microseconds from a second pass that waits
    for each frame before the next starts — the tail-latency (p99)
    number realtime audio cares about. That pass also records the
    ``serve/frame`` spans and the ``serve/frames/wall_us`` histogram when
    ``repro_torch.obs`` is enabled, after each frame's timing."""
    if mesh is not None:
        raise NotImplementedError(
            "rnn_serve_frames(mesh=...) waits for the multi-device slice "
            "of the port (slice 5: sharded CSB)")
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
    if state is None:
        state = init_state(graph, tuple(frames.shape[1:-1]), torch.float32,
                           device=dev)
    else:
        state = {k: v.to(dev) for k, v in state.items()}
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    def step(st, x):
        return cell_apply(graph, params, x, st)

    n = frames.shape[0]
    with torch.no_grad():
        for _ in range(warmup):
            step(state, frames[0])
        sync()

        outs = []
        t0 = time.perf_counter()
        st = state
        for t in range(n):
            y, st = step(st, frames[t])
            outs.append(y)
        sync()
        dt = time.perf_counter() - t0

        frame_us = None
        if collect_frame_times:
            # a separate pass, so the throughput number above is untouched
            # by the per-frame waits; spans and histogram are recorded
            # after each frame's timing
            tr = obs_trace.get()
            reg = obs_metrics.get()
            frame_us = np.empty(n)
            st2 = state
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
                    reg.histogram("serve/frames/wall_us").observe(dur / 1e3)
    us_per_frame = dt / n * 1e6
    if collect_frame_times:
        return torch.stack(outs), st, us_per_frame, frame_us
    return torch.stack(outs), st, us_per_frame
