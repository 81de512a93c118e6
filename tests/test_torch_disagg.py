"""Disaggregated serving (prefill tier -> page handoff -> decode tier)
against the JAX package: the unsharded cases of tests/test_disagg.py.

Greedy ``serve_disaggregated`` gives JAX's ``serve_continuous`` tokens,
the port's own ``serve_continuous`` tokens and JAX's
``serve_disaggregated`` stats on the same traces, with JAX's
``PRNGKey(0)`` parameters carried across by ``lm_params_from_numpy``.
At temperature > 0 JAX's key streams cannot be matched; the port's
analogue of ``test_disagg_nongreedy_parity_same_rng`` holds the two
port engines to equal tokens from generators in the same state. The
decode tier's paged-attention kernel runs its plain version here.
Reduced hymba-1.5b (nested cache, no bucketing) and deepseek-v2-236b
(MLA, MoE) go through both tiers too; the mesh cases are in
tests/test_torch_serve_mesh*.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as j_configs
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.obs import metrics as j_metrics
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig, init_params
from repro_torch.obs import metrics as t_metrics
from repro_torch.serve import (
    DecodeTier, EngineConfig, PageHandoff, PrefillTier, Request,
    serve_continuous, serve_disaggregated,
)

CFG = dict(name="tiny-disagg", mixer="attn", ffn="swiglu", n_layers=2,
           d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=50,
           dtype="float32", logit_chunk=16, remat=False)
PAGED = dict(n_slots=2, paged=True, page_size=4)
_TIMED = ("tokens_per_sec", "compile_time_s", "steady_tokens_per_sec")


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _skewed_trace(make, seed=5, n=8, vocab=50):
    """tests/test_disagg.py's trace: mixed lengths, staggered arrivals."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(9, 14)) if i % 3 == 0 else \
            int(rng.integers(4, 8))
        reqs.append(make(rid=i, tokens=rng.integers(0, vocab, size=plen),
                         max_new_tokens=int(rng.integers(3, 7)),
                         arrival=(i // 2) * 3))
    return reqs


def _shared_trace(make, seed=7, n=6):
    """tests/test_disagg.py's prefix trace: divergence mid-page."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 50, size=9)
    return [make(rid=i,
                 tokens=np.concatenate(
                     [sys_p, rng.integers(0, 50,
                                          size=int(rng.integers(1, 5)))]),
                 max_new_tokens=4, arrival=(i // 3) * 2)
            for i in range(n)]


def _untimed(stats):
    return {k: v for k, v in stats.items() if k not in _TIMED}


def _jtokens(res):
    return {k: list(v) for k, v in res.tokens.items()}


def _run(tiny, trace, **engine):
    """(JAX serve_continuous, JAX disagg, port serve_continuous, port
    disagg) on ``trace``."""
    jcfg, tcfg, jp, tp = tiny
    return (J.serve_continuous(jp, jcfg, trace(J.Request),
                               J.EngineConfig(**engine)),
            J.serve_disaggregated(jp, jcfg, trace(J.Request),
                                  J.EngineConfig(**engine)),
            serve_continuous(tp, tcfg, trace(Request),
                             EngineConfig(**engine), device="cpu"),
            serve_disaggregated(tp, tcfg, trace(Request),
                                EngineConfig(**engine), device="cpu"))


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_disagg_matches_single_engine(tiny, use_kernel):
    """JAX's serve_continuous tokens, the port's serve_continuous tokens,
    JAX's disagg stats; one handoff per request, each mapping pages. The
    kernel case runs the decode tier through the kernel's wrapper (its
    plain version here)."""
    js, jd, ts, td = _run(tiny, _skewed_trace, use_kernel=use_kernel,
                          **PAGED)
    assert td.tokens == _jtokens(js) == ts.tokens
    assert _untimed(td.stats) == _untimed(jd.stats)
    assert td.stats["disagg"] and td.stats["paged"]
    assert td.stats["handoffs"] == 8 and td.stats["handoff_pages"] > 0
    assert td.stats["prefill_tokens"] >= sum(
        r.prompt_len for r in _skewed_trace(Request))


def test_disagg_prefix_sharing_parity(tiny):
    js, jd, ts, td = _run(tiny, _shared_trace, prefix_cache=True, **PAGED)
    assert td.tokens == _jtokens(js) == ts.tokens
    assert _untimed(td.stats) == _untimed(jd.stats)
    assert td.stats["prefix_hits"] == ts.stats["prefix_hits"] > 0
    # the partial prefill through the handoff really skipped shared tokens
    _, tcfg, _, tp = tiny
    off = serve_disaggregated(tp, tcfg, _shared_trace(Request),
                              EngineConfig(**PAGED), device="cpu")
    assert td.stats["prefill_tokens"] < off.stats["prefill_tokens"]
    assert off.tokens == td.tokens


def test_disagg_nongreedy_parity_same_generator(tiny):
    """Temperature > 0: both port engines draw from generators in the
    same state, first tokens at admission then each step's, in the same
    order, so even sampled tokens agree."""
    _, tcfg, _, tp = tiny
    cfg = EngineConfig(temperature=0.8, **PAGED)
    single = serve_continuous(tp, tcfg, _skewed_trace(Request, 9, 5), cfg,
                              device="cpu",
                              generator=torch.Generator().manual_seed(42))
    dis = serve_disaggregated(tp, tcfg, _skewed_trace(Request, 9, 5), cfg,
                              device="cpu",
                              generator=torch.Generator().manual_seed(42))
    assert dis.tokens == single.tokens
    # the default generator is seeded 0 in both
    a = serve_continuous(tp, tcfg, _skewed_trace(Request, 9, 5), cfg,
                         device="cpu")
    b = serve_disaggregated(tp, tcfg, _skewed_trace(Request, 9, 5), cfg,
                            device="cpu")
    assert a.tokens == b.tokens


def test_disagg_finish_at_prefill(tiny):
    """max_new_tokens=1 requests finish at the handoff boundary: nothing
    is mapped into the decode pool for them."""
    jcfg, tcfg, jp, tp = tiny

    def trace(make):
        rng = np.random.default_rng(2)
        return [make(rid=i, tokens=rng.integers(0, 50, size=5),
                     max_new_tokens=1) for i in range(3)]

    js, jd, ts, td = _run(tiny, trace, **PAGED)
    assert td.tokens == _jtokens(js) == ts.tokens
    assert td.stats["handoffs"] == 3 and td.stats["handoff_pages"] == 0
    assert _untimed(td.stats) == _untimed(jd.stats)


MODELS = {"hymba": "hymba-1.5b", "deepseek": "deepseek-v2-236b"}


@pytest.mark.parametrize("name", list(MODELS))
def test_disagg_other_mixers_match_jax(name):
    """Reduced hymba-1.5b (nested cache, state leaves per slot, no
    bucketing) and deepseek-v2-236b (MLA pools, MoE) through both tiers:
    JAX's disagg tokens and stats, the port's serve_continuous tokens."""
    arch = MODELS[name]
    jcfg, tcfg = j_configs.get_reduced(arch), t_configs.get_reduced(arch)
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")

    def trace(make):
        rng = np.random.default_rng(3)
        return [make(rid=i, tokens=rng.integers(0, jcfg.vocab, size=n),
                     max_new_tokens=3, arrival=a)
                for i, (n, a) in enumerate(((2, 0), (6, 0), (6, 2)))]

    engine = dict(paged=True, page_size=4, n_slots=2, use_kernel=True)
    jd = J.serve_disaggregated(jp, jcfg, trace(J.Request),
                               J.EngineConfig(**engine))
    td = serve_disaggregated(tp, tcfg, trace(Request),
                             EngineConfig(**engine), device="cpu")
    ts = serve_continuous(tp, tcfg, trace(Request), EngineConfig(**engine),
                          device="cpu")
    assert td.tokens == _jtokens(jd) == ts.tokens
    assert _untimed(td.stats) == _untimed(jd.stats)
    assert td.stats["bucketed_prefill"] == (name == "deepseek")


# ---------------------------------------------------------------------------
# the tiers and their guard rails
# ---------------------------------------------------------------------------

def test_disagg_requires_paged(tiny):
    _, tcfg, _, tp = tiny
    with pytest.raises(ValueError, match="paged=True"):
        serve_disaggregated(tp, tcfg, _skewed_trace(Request, n=2),
                            EngineConfig(n_slots=2), device="cpu")


def test_disagg_empty_trace_stats_equal_jax(tiny):
    jcfg, tcfg, jp, tp = tiny
    for engine in (PAGED, dict(PAGED, pool_pages=7, prefix_cache=True)):
        jr = J.serve_disaggregated(jp, jcfg, [], J.EngineConfig(**engine))
        tr = serve_disaggregated(tp, tcfg, [], EngineConfig(**engine),
                                 device="cpu")
        assert tr.tokens == {} and tr.stats["handoffs"] == 0
        assert tr.stats == jr.stats and tr.wall_s == 0.0


def test_disagg_cache_len_too_short_raises(tiny):
    _, tcfg, _, tp = tiny
    with pytest.raises(ValueError, match="cannot hold"):
        serve_disaggregated(tp, tcfg, _skewed_trace(Request, n=3),
                            EngineConfig(cache_len=8, **PAGED),
                            device="cpu")


def test_disagg_mesh_raises(tiny):
    """``mesh=`` takes a DeviceMesh (tests/test_torch_serve_mesh*.py
    serve on one); anything else raises."""
    _, tcfg, _, tp = tiny
    with pytest.raises(TypeError, match="DeviceMesh"):
        serve_disaggregated(tp, tcfg, [], EngineConfig(**PAGED),
                            mesh=object(), device="cpu")


def test_disagg_raises_without_cuda_unless_asked(tiny):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    _, tcfg, _, tp = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_disaggregated(tp, tcfg, _skewed_trace(Request, n=2),
                            EngineConfig(**PAGED))


def test_tiers_share_one_head(tiny):
    """The decode tier takes the prefill tier's fp32 head (``head=``),
    so a low-precision model keeps one copy; a handoff is inert until
    accepted, and accepting maps the prompt's pages."""
    _, tcfg, _, tp = tiny
    cfg = EngineConfig(**PAGED)
    pre = PrefillTier(tp, tcfg, cfg, device="cpu")
    dec = DecodeTier(tp, tcfg, cfg, 24, head=pre.runner.head, device="cpu")
    assert dec.runner.head is pre.runner.head
    req = Request(rid=0, tokens=np.arange(6) % 50, max_new_tokens=3)
    dec.sched.submit(req)
    [(slot, r)] = dec.sched.admit()
    h = pre.run(r, slot, lambda lg: torch.argmax(lg, dim=-1))
    assert isinstance(h, PageHandoff) and h.suffix_start == 0
    assert dec.pool.slot_pages(slot) == []
    assert dec.accept(h)
    assert len(dec.pool.slot_pages(slot)) == 2 == dec.handoff_pages
    assert int(dec.cur[slot, 0]) == h.first_token
    assert pre.prefill_tokens == 8          # bucketed to 8


def test_disagg_emits_jax_obs_names(tiny):
    """With the metrics registry on, the run records the names JAX's
    does: tier backlog and occupancy gauges, per-tier queue-wait
    histograms, handoff counters."""
    jcfg, tcfg, jp, tp = tiny
    names = []
    for mod, serve, cfg, params, make, kw in (
            (j_metrics, J.serve_disaggregated, jcfg, jp, J.Request, {}),
            (t_metrics, serve_disaggregated, tcfg, tp, Request,
             {"device": "cpu"})):
        engine = (J.EngineConfig if mod is j_metrics else EngineConfig)
        mod.enable()
        try:
            serve(params, cfg, _skewed_trace(make, n=4), engine(**PAGED),
                  **kw)
        finally:
            reg = mod.disable()
        d = reg.to_dict(series=False)
        names.append({kind: sorted(d[kind]) for kind in
                      ("counters", "gauges", "histograms")})
    assert names[0] == names[1]
    for name in ("serve/tier/prefill_backlog", "serve/tier/decode_active"):
        assert name in names[1]["gauges"]
    for name in ("serve/disagg/prefill_queue_us",
                 "serve/disagg/handoff_queue_us"):
        assert name in names[1]["histograms"]
    assert "serve/handoff/count" in names[1]["counters"]


def test_disagg_bf16_runs_and_matches_continuous():
    """A bf16 model through both tiers: the port's serve_continuous
    tokens (the same kernels in the same order)."""
    tcfg = dataclasses.replace(ModelConfig(**CFG), dtype="bfloat16")
    tp = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    cfg = EngineConfig(**PAGED)
    a = serve_continuous(tp, tcfg, _skewed_trace(Request), cfg,
                         device="cpu")
    b = serve_disaggregated(tp, tcfg, _skewed_trace(Request), cfg,
                            device="cpu")
    assert a.tokens == b.tokens
