"""Port of the prefix cache: models/layers.py's ``context_attention``,
models/lm.py's ``prefill_partial``, serve/scheduler.py's
``insert_paged_span``/``copy_page_cache``, and serve/engine.py's
``_gather_ctx`` and ``prefix_cache=True`` branches.

The JAX package's parameters (through ``lm_params_from_numpy``) serve the
same shared-prefix traces through both engines, for reduced gemma-2b and
tests/test_speculative.py's tiny ``CFG`` and windowed ``WIN``: greedy
tokens are identical to JAX's, to ``prefix_cache=False`` and to
``generate``, and the partial prefill agrees with JAX's at 2e-5. The
MLA cases of tests/test_serve_prefix.py are in
tests/test_torch_prefix_spec_mla_moe.py. Also:
a divergence mid-page copies the page before the suffix lands (the
first request's tokens do not move), a scratch page filled with large
values changes no token (nothing reads it unmasked), and
tests/test_paging.py's prefix fuzz traces drive the JAX pool and the
port's in lockstep with ``check()`` after every event."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import PagePool as JPagePool
from repro.serve import Request as JRequest
from repro.serve import SlotScheduler as JSlotScheduler
from repro.serve import engine as j_engine
from repro.serve import scheduler as j_sched
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import (
    EngineConfig, PagePool, Request, SlotScheduler, generate,
    serve_continuous,
)
from repro_torch.serve import engine as t_engine
from repro_torch.serve import scheduler as t_sched

CFG = dict(name="tiny-spec", mixer="attn", ffn="swiglu", n_layers=2,
           d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=50,
           dtype="float32", logit_chunk=16, remat=False)
WIN = dict(CFG, name="tiny-spec-win", window=6)
CFGS = {"gemma-2b-reduced": None, "attn": CFG, "win": WIN}
TOL = 2e-5
_TIMED = ("tokens_per_sec", "compile_time_s", "steady_tokens_per_sec")


def _model(name):
    spec = CFGS[name]
    if spec is None:
        jcfg = j_configs.get_reduced("gemma-2b")
        tcfg = t_configs.get_reduced("gemma-2b")
    else:
        jcfg, tcfg = JModelConfig(**spec), ModelConfig(**spec)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def gemma():
    return _model("gemma-2b-reduced")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


def _shared_trace(vocab, seed=7, sys_len=9, n=6):
    """tests/test_serve_prefix.py's trace: n requests sharing one system
    prompt, staggered arrivals, short random tails; sys_len=9 with
    page_size=4 puts the divergence mid-page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, size=sys_len)
    return [(np.concatenate([sys_p, rng.integers(
        0, vocab, size=int(rng.integers(1, 5)))]), 4, (i // 3) * 2)
        for i in range(n)]


def _engine(prefix, **kw):
    return dict(n_slots=2, paged=True, page_size=4, prefix_cache=prefix,
                **kw)


def _serve(tp, tcfg, trace, **engine):
    return serve_continuous(tp, tcfg, [
        Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], EngineConfig(**engine),
        device="cpu")


def _j_serve(jp, jcfg, trace, **engine):
    return j_serve(jp, jcfg, [
        JRequest(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], JEngineConfig(**engine))


# ---------------------------------------------------------------------------
# token parity (tests/test_serve_prefix.py, attn)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_prefix_on_matches_off_and_generate(model, use_kernel):
    jcfg, tcfg, jp, tp = model
    trace = _shared_trace(jcfg.vocab)
    off = _serve(tp, tcfg, trace, **_engine(False, use_kernel=use_kernel))
    on = _serve(tp, tcfg, trace, **_engine(True, use_kernel=use_kernel))
    want = _j_serve(jp, jcfg, trace, **_engine(True))
    assert on.tokens == off.tokens == want.tokens
    assert on.stats["prefix_cache"] and not off.stats["prefix_cache"]
    assert set(on.stats) == set(want.stats)
    for k, v in want.stats.items():
        if k not in _TIMED:
            assert on.stats[k] == v, k
    # the scalar-pos reference: generate() decodes with a scalar position
    for i, (p, m, _) in enumerate(trace):
        ref = generate(tp, tcfg, p[None], EngineConfig(max_new_tokens=m),
                       device="cpu")
        assert on.tokens[i] == ref[0, len(p):].tolist(), i


def test_prefix_sharing_actually_shares(model):
    jcfg, tcfg, _, tp = model
    trace = _shared_trace(jcfg.vocab)
    off = _serve(tp, tcfg, trace, **_engine(False))
    on = _serve(tp, tcfg, trace, **_engine(True))
    # every request after the first hits the shared system prompt
    assert on.stats["prefix_hits"] == len(trace) - 1
    assert on.stats["shared_pages"] > 0
    assert on.stats["prefill_tokens"] < off.stats["prefill_tokens"]
    # 9-token prompt, page_size=4: divergence lands inside page 2 -> CoW
    assert on.stats["paging"]["cow_copies"] > 0
    assert "prefix_hits" not in off.stats


def test_prefix_off_by_default_and_requires_paged(gemma):
    _, tcfg, _, tp = gemma
    trace = _shared_trace(tcfg.vocab, n=2)
    res = _serve(tp, tcfg, trace, n_slots=2, paged=True, page_size=4)
    assert not res.stats["prefix_cache"]
    with pytest.raises(ValueError, match="prefix_cache"):
        _serve(tp, tcfg, trace, n_slots=2, prefix_cache=True)


def test_mid_page_divergence_copies_before_the_suffix_lands(model):
    """Request 1 shares request 0's first six tokens and diverges inside
    request 0's second page while request 0 is still decoding: its
    admission copies that page before the suffix write, so request 0's
    tokens are those it decodes alone, and both equal JAX's."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(21)
    a = rng.integers(0, jcfg.vocab, size=10)
    b = np.concatenate([a[:6], (a[6:9] + 1) % jcfg.vocab])
    trace = [(a, 6, 0), (b, 4, 2)]
    both = _serve(tp, tcfg, trace, **_engine(True))
    alone = _serve(tp, tcfg, trace[:1], **_engine(True))
    assert both.stats["prefix_hits"] == 1
    assert both.stats["paging"]["cow_copies"] == 1
    assert both.tokens[0] == alone.tokens[0]
    assert both.tokens == _j_serve(jp, jcfg, trace, **_engine(True)).tokens
    assert both.tokens == _serve(tp, tcfg, trace, **_engine(False)).tokens


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_scratch_page_is_never_read_unmasked(gemma, monkeypatch,
                                             use_kernel):
    """Fill the scratch page with 1e4 before every decode step and every
    context gather (pad writes land there as well): no token moves."""
    _, tcfg, _, tp = gemma
    trace = _shared_trace(tcfg.vocab, seed=9)
    clean = _serve(tp, tcfg, trace, **_engine(True, use_kernel=use_kernel))

    def poison(cache):
        for leaf in cache.values():
            leaf[:, -1] = 1e4

    step, gather = TLM.decode_step_paged, t_engine._gather_ctx

    def poisoned_step(params, cache, *a, **k):
        poison(cache)
        return step(params, cache, *a, **k)

    def poisoned_gather(cache, pages):
        poison(cache)
        return gather(cache, pages)

    monkeypatch.setattr(TLM, "decode_step_paged", poisoned_step)
    monkeypatch.setattr(t_engine, "_gather_ctx", poisoned_gather)
    dirty = _serve(tp, tcfg, trace, **_engine(True, use_kernel=use_kernel))
    assert dirty.stats["prefix_hits"] > 0
    assert dirty.tokens == clean.tokens


# ---------------------------------------------------------------------------
# the partial prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("start,c", [(5, 8), (8, 8), (3, 16)])
def test_context_attention_matches_jax(window, start, c):
    rng = np.random.default_rng(start + c)
    b, s, h, kv, d = 1, 5, 4, 2, 16

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    q, k, v = r(b, s, h, d), r(b, s, kv, d), r(b, s, kv, d)
    ck, cv = r(b, c, kv, d), r(b, c, kv, d)
    want = JL.context_attention(*map(jnp.asarray, (q, k, v, ck, cv)),
                                start, window=window)
    got = TL.context_attention(*map(torch.from_numpy, (q, k, v, ck, cv)),
                               start, window=window)
    _close(got, want)


@pytest.mark.parametrize("start,ctx_pages", [(8, 2), (6, 2), (5, 4)])
def test_prefill_partial_matches_jax_and_full_prefill(model, start,
                                                      ctx_pages):
    """Suffix logits and KV against JAX's ``prefill_partial`` on the same
    gathered context (page-padded past ``start``), and against the
    port's full prefill of the whole prompt."""
    jcfg, tcfg, jp, tp = model
    prompt = np.random.default_rng(start).integers(0, jcfg.vocab, size=13)
    _, jfull = JLM.prefill(jp, {"tokens": jnp.asarray(prompt)[None]}, jcfg)
    width = ctx_pages * 4
    ctx = {k: np.pad(np.asarray(v)[:, :, :start],
                     [(0, 0), (0, 0), (0, width - start), (0, 0), (0, 0)])
           for k, v in jfull.items()}
    suffix = prompt[start:]
    jl, jc = JLM.prefill_partial(jp, {"tokens": jnp.asarray(suffix)[None]},
                                 {k: jnp.asarray(v) for k, v in ctx.items()},
                                 jcfg, start=start)
    tl, tc = TLM.prefill_partial(
        tp, {"tokens": torch.as_tensor(suffix)[None]},
        {k: torch.from_numpy(v) for k, v in ctx.items()}, tcfg, start=start)
    _close(tl, jl)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    fl, fc = TLM.prefill(tp, {"tokens": torch.as_tensor(prompt)[None]}, tcfg)
    _close(tl, fl)
    for k in ("k", "v"):
        _close(tc[k], fc[k][:, :, start:])
    # last_pos picks a suffix position, as the bucketed engine does
    tl2, _ = TLM.prefill_partial(
        tp, {"tokens": torch.as_tensor(np.pad(suffix, (0, 3)))[None]},
        {k: torch.from_numpy(v) for k, v in ctx.items()}, tcfg, start=start,
        last_pos=len(suffix) - 1)
    _close(tl2, tl)


# ---------------------------------------------------------------------------
# the device half: span insert, page copy, context gather
# ---------------------------------------------------------------------------

def _pool_cache(seed, l=2, n=7, p=4, kv=2, d=4):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((l, n, p, kv, d)).astype(np.float32)
            for k in ("k", "v")}


@pytest.mark.parametrize("start,length,s_pad", [(6, 5, 8), (8, 3, 4),
                                                (1, 7, 7)])
def test_insert_paged_span_matches_jax(start, length, s_pad):
    pool = _pool_cache(1)                    # 6 pages + scratch (6)
    rng = np.random.default_rng(2)
    span = {k: rng.standard_normal((2, 1, s_pad, 2, 4)).astype(np.float32)
            for k in pool}
    row = np.asarray([3, 0, 5, 6, 6], np.int32)
    want = j_sched.insert_paged_span(
        {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in span.items()}, row, start, length,
        0)
    batch = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    got = t_sched.insert_paged_span(
        batch, {k: torch.from_numpy(v) for k, v in span.items()}, row,
        start, length, 0)
    assert got is batch
    for k in pool:       # the scratch page's pad rows are not compared
        np.testing.assert_array_equal(got[k][:, :6].numpy(),
                                      np.asarray(want[k])[:, :6])


def test_copy_page_and_gather_ctx_match_jax():
    pool = _pool_cache(3)
    jc = {k: jnp.asarray(v) for k, v in pool.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    want = j_sched.copy_page_cache(jc, 4, 1)
    got = t_sched.copy_page_cache(tc, 4, 1)
    assert got is tc
    for k in pool:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    pages = np.asarray([2, 1, 6, 6], np.int32)
    want = j_engine._gather_ctx(want, pages)
    got = t_engine._gather_ctx(got, pages)
    for k in pool:
        assert tuple(got[k].shape) == want[k].shape == (2, 1, 16, 2, 4)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the prefix fuzz traces of tests/test_paging.py, both pools in lockstep
# ---------------------------------------------------------------------------

N_SWEEPS = 10          # 60 traces
TRACES_PER_SWEEP = 6


def _prefix_reqs(rng, n_reqs, cap_tokens):
    """tests/test_paging.py's shared-prefix request mix."""
    bases, reqs = [], []
    for i in range(n_reqs):
        total = int(rng.integers(2, cap_tokens + 1))
        plen = int(rng.integers(1, total))
        if bases and rng.random() < 0.7:
            base = bases[int(rng.integers(len(bases)))]
            keep = int(rng.integers(1, min(plen, len(base)) + 1))
            toks = np.concatenate([
                base[:keep],
                rng.integers(0, 7, size=plen - keep)]).astype(np.int32)
        else:
            toks = rng.integers(0, 7, size=plen).astype(np.int32)
        if len(bases) < 4 or rng.random() < 0.3:
            bases.append(toks)
        reqs.append((i, toks, total - plen,
                     int(rng.integers(0, 3 * n_reqs))))
    return reqs


def _agree(jpool, tpool, jsched, tsched):
    tpool.check()
    np.testing.assert_array_equal(tpool.device_table().numpy(),
                                  np.asarray(jpool.device_table()))
    assert tpool._ref == jpool._ref and tpool._free == jpool._free
    assert tpool.available() == jpool.available()
    assert tpool.trie_pages() == jpool.trie_pages()
    np.testing.assert_array_equal(tsched.positions(), jsched.positions())


def run_prefix_trace(rng, n_slots, page_size, n_pages, max_pages, n_reqs):
    """The engine's prefix-cache admission protocol (one admission at a
    time, ``cow_if_needed``, ``ensure``, ``register_prefix``, decode
    growth, release) on the JAX pool and the port's at once."""
    if min(n_pages, max_pages) * page_size < 2:
        page_size = 2       # smallest request (1 prompt + 1 new) must fit
    jpool = JPagePool(page_size, n_pages, n_slots, max_pages,
                      prefix_cache=True)
    tpool = PagePool(page_size, n_pages, n_slots, max_pages,
                     prefix_cache=True, device="cpu")
    jsched, tsched = JSlotScheduler(n_slots, pool=jpool), \
        SlotScheduler(n_slots, pool=tpool)
    reqs = _prefix_reqs(rng, n_reqs, min(n_pages, max_pages) * page_size)
    for rid, toks, new, arrival in reqs:
        jsched.submit(JRequest(rid=rid, tokens=toks, max_new_tokens=new,
                               arrival=arrival))
        tsched.submit(Request(rid=rid, tokens=toks, max_new_tokens=new,
                              arrival=arrival))
    _agree(jpool, tpool, jsched, tsched)
    guard = sum(new + a for _, _, new, a in reqs) + 10 * n_reqs + 10
    while tsched.has_work():
        while True:
            jb, tb = jsched.admit(limit=1), tsched.admit(limit=1)
            assert [(s, r.rid) for s, r in jb] == [(s, r.rid) for s, r in tb]
            if not tb:
                break
            [(slot, req)] = tb
            assert dataclasses.astuple(tpool.shared_info(slot)) \
                == dataclasses.astuple(jpool.shared_info(slot))
            assert tpool.cow_if_needed(slot) == jpool.cow_if_needed(slot)
            _agree(jpool, tpool, jsched, tsched)
            toks = np.asarray(req.tokens).reshape(-1)
            for pool in (jpool, tpool):
                pool.ensure(slot, req.prompt_len)
            assert tpool.register_prefix(slot, toks) \
                == jpool.register_prefix(slot, toks)
            _agree(jpool, tpool, jsched, tsched)
            first = int(rng.integers(0, 100))
            assert tsched.started(slot, first) == jsched.started(slot, first)
            _agree(jpool, tpool, jsched, tsched)
        active = tsched.active_mask()
        if not active.any():
            jsched.idle_tick()
            tsched.idle_tick()
            guard -= 1
            assert guard > 0
            continue
        pos = tsched.positions()
        for i in np.flatnonzero(active):
            assert tpool.ensure(int(i), int(pos[i]) + 1) \
                == jpool.ensure(int(i), int(pos[i]) + 1)
            _agree(jpool, tpool, jsched, tsched)
        jpool.tick()
        tpool.tick()
        sampled = rng.integers(0, 100, size=n_slots)
        assert tsched.advance(sampled) == jsched.advance(sampled)
        _agree(jpool, tpool, jsched, tsched)
        guard -= 1
        assert guard > 0, "prefix trace did not terminate"
    assert not jsched.has_work()
    assert tpool.drop_prefix_cache() == jpool.drop_prefix_cache()
    tpool.check()
    assert tpool.allocated_total() == 0
    assert tsched.results == jsched.results
    assert tsched.stats() == jsched.stats()
    return tsched.stats()


@pytest.mark.parametrize("sweep", range(N_SWEEPS))
def test_fuzz_prefix_traces_match_jax(sweep):
    rng = np.random.default_rng(104729 * sweep + 31)
    for _ in range(TRACES_PER_SWEEP):
        n_slots = int(rng.integers(1, 5))
        page_size = int(rng.integers(1, 6))
        max_pages = int(rng.integers(1, 9))
        n_pages = int(rng.integers(1, n_slots * max_pages + 2))
        n_reqs = int(rng.integers(1, 13))
        run_prefix_trace(rng, n_slots, page_size, n_pages, max_pages,
                         n_reqs)


def test_fuzz_prefix_traces_share():
    """An ample pool and the shared-prefix mix must register hits."""
    rng = np.random.default_rng(5)
    hits = sum(run_prefix_trace(rng, 3, 2, 24, 8, 10)["prefix_hits"]
               for _ in range(4))
    assert hits > 0
