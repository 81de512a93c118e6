"""Port of serve/engine.py's paged ``serve_continuous`` and the device
half of serve/scheduler.py.

The JAX package's parameters (through ``lm_params_from_numpy``) serve the
same requests through both engines: greedy tokens must be identical,
with the paged-attention kernel off and on (on the CPU the kernel path
runs its plain version), for reduced gemma-2b and tests/test_paged_attn.py's
``ATTN`` (n_kv=2) and ``WIN`` (window=6) configs. Also: prompt bucketing
never changes tokens, one slot evicted and refilled decodes each request
as alone, the scheduler's stats equal JAX's, and the cache helpers
equal JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.obs import metrics as j_metrics, trace as j_trace
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import bucket_len as j_bucket_len
from repro.serve import scheduler as j_sched
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import paged_attn
from repro_torch.models import ModelConfig, init_params
from repro_torch.obs import metrics as t_metrics, trace as t_trace
from repro_torch.serve import (
    EngineConfig, Request, ServeResult, bucket_len, serve_continuous,
)
from repro_torch.serve import scheduler as t_sched

ATTN = dict(name="tiny-pa-attn", mixer="attn", ffn="swiglu", n_layers=2,
            d_model=32, n_heads=4, n_kv=2, head_dim=16, d_ff=64, vocab=50,
            dtype="float32", logit_chunk=16, remat=False)
WIN = dict(ATTN, name="tiny-pa-win", window=6)
CFGS = {"gemma-2b-reduced": None, "attn": ATTN, "win": WIN}

# steady-state and wall-clock numbers differ between engines by nature
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
    """Each configuration: the token-parity tests run on all three."""
    return _model(request.param)


@pytest.fixture(scope="module")
def gemma():
    """Reduced gemma-2b alone, for the engine's other behaviours."""
    return _model("gemma-2b-reduced")


def _trace(vocab, lens, max_new, arrivals, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=n) for n in lens]
    return list(zip(prompts, max_new, arrivals))


def _serve_both(model, trace, **engine):
    jcfg, tcfg, jp, tp = model
    jr = j_serve(jp, jcfg, [
        JRequest(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], JEngineConfig(**engine))
    tr = serve_continuous(tp, tcfg, [
        Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], EngineConfig(**engine),
        device="cpu")
    return jr, tr


MIXED = dict(lens=(4, 8, 5, 7, 6, 11), max_new=(4, 6, 5, 4, 6, 3),
             arrivals=(0, 0, 3, 6, 6, 9))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_greedy_tokens_equal_jax(model, use_kernel):
    jcfg = model[0]
    trace = _trace(jcfg.vocab, seed=5, **MIXED)
    before = paged_attn.LAUNCHES
    jr, tr = _serve_both(model, trace, n_slots=2, paged=True, page_size=4,
                         use_kernel=use_kernel)
    assert paged_attn.LAUNCHES == before      # the CPU runs the plain path
    assert isinstance(tr, ServeResult)
    assert tr.tokens == jr.tokens
    assert set(tr.stats) == set(jr.stats)
    for k, v in jr.stats.items():
        if k not in _TIMED:
            assert tr.stats[k] == v, k


def test_bucket_len_matches_jax():
    for n in list(range(0, 70)) + [100, 1000, 1025]:
        assert bucket_len(n) == j_bucket_len(n)
        assert bucket_len(n, floor=1) == j_bucket_len(n, floor=1)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_bucketing_never_changes_tokens(model, use_kernel):
    jcfg, tcfg, _, tp = model
    trace = _trace(jcfg.vocab, (3, 9, 13, 6), (5, 4, 3, 6), (0,) * 4, 9)

    def run(bucket):
        return serve_continuous(tp, tcfg, [
            Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(trace)], EngineConfig(
                n_slots=2, paged=True, page_size=4, use_kernel=use_kernel,
                bucket_prompts=bucket), device="cpu")

    on, off = run(True), run(False)
    assert on.stats["bucketed_prefill"] and not off.stats["bucketed_prefill"]
    assert on.stats["prefill_tokens"] == sum(bucket_len(n)
                                             for n in (3, 9, 13, 6))
    assert off.stats["prefill_tokens"] == 3 + 9 + 13 + 6
    assert on.tokens == off.tokens


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_evict_refill_one_slot_equals_jax(model, use_kernel):
    """Two different requests forced through the same slot, the second
    on recycled pages: tokens as JAX's, and each as it decodes alone."""
    jcfg, tcfg, _, tp = model
    trace = _trace(jcfg.vocab, (9, 4), (5, 6), (0, 0), 3)
    engine = dict(n_slots=1, paged=True, page_size=4, use_kernel=use_kernel)
    jr, tr = _serve_both(model, trace, **engine)
    assert tr.tokens == jr.tokens
    assert tr.stats["prefills"] == 2 and tr.stats["peak_active"] == 1
    for i, (p, m, _) in enumerate(trace):
        alone = serve_continuous(tp, tcfg, [Request(
            rid=0, tokens=p, max_new_tokens=m)], EngineConfig(**engine),
            device="cpu")
        assert alone.tokens[0] == tr.tokens[i]


def test_small_pool_admission_equals_jax(gemma):
    """A pool smaller than the slots' worst case: admission stalls for
    pages as in JAX, with the same tokens."""
    jcfg = gemma[0]
    trace = _trace(jcfg.vocab, (8, 8, 8, 8, 8), (8, 4, 4, 4, 4),
                   (0,) * 5, 11)
    jr, tr = _serve_both(gemma, trace, n_slots=4, paged=True, page_size=4,
                         cache_len=16, pool_pages=8)
    assert tr.tokens == jr.tokens
    assert tr.stats["page_stalls"] == jr.stats["page_stalls"] > 0
    assert tr.stats["paging"] == jr.stats["paging"]


def test_prefill_only_request_equals_jax(gemma):
    jcfg = gemma[0]
    trace = _trace(jcfg.vocab, (5, 7), (1, 3), (0, 0), 12)
    jr, tr = _serve_both(gemma, trace, n_slots=2, paged=True, page_size=4)
    assert tr.tokens == jr.tokens
    assert len(tr.tokens[0]) == 1


def test_obs_spans_and_histograms_match_jax(gemma):
    """The same span and histogram names, and the same counts, as the
    JAX engine emits for one trace."""
    jcfg, tcfg, jp, tp = gemma
    trace = _trace(jcfg.vocab, (4, 9, 3), (3, 2, 4), (0, 0, 2), 13)
    engine = dict(n_slots=2, paged=True, page_size=4)
    runs = (
        (j_trace, j_metrics, lambda: j_serve(jp, jcfg, [
            JRequest(rid=i, tokens=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(trace)], JEngineConfig(**engine))),
        (t_trace, t_metrics, lambda: serve_continuous(tp, tcfg, [
            Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(trace)], EngineConfig(**engine),
            device="cpu")))
    out = []
    for trace_mod, metrics_mod, run in runs:
        tr_, reg = trace_mod.enable(), metrics_mod.enable()
        try:
            res = run()
        finally:
            trace_mod.disable(), metrics_mod.disable()
        names = sorted((ph, name) for ph, name, *_ in tr_.events())
        hist = {k: v["count"] for k, v in
                reg.to_dict(series=False)["histograms"].items()}
        out.append((names, hist, res.tokens))
    assert out[0] == out[1]


def test_sampling_at_temperature_draws_from_the_generator(gemma):
    _, tcfg, _, tp = gemma
    trace = _trace(tcfg.vocab, (4, 6), (5, 5), (0, 0), 14)
    reqs = [Request(rid=i, tokens=p, max_new_tokens=m)
            for i, (p, m, _) in enumerate(trace)]
    cfg = EngineConfig(n_slots=2, paged=True, page_size=4, temperature=0.8)

    def run(seed):
        return serve_continuous(tp, tcfg, reqs, cfg, device="cpu",
                                generator=torch.Generator().manual_seed(
                                    seed)).tokens

    a, b = run(0), run(0)
    assert a == b
    assert all(0 <= t < tcfg.vocab and len(v) == 5
               for v in a.values() for t in v)
    assert any(run(s) != a for s in (1, 2, 3))


@pytest.mark.parametrize("engine,match", [
    (dict(paged=False), "contiguous"),
    (dict(paged=True, prefix_cache=True), "prefix"),
    (dict(paged=True, speculative=True), "speculative"),
])
def test_unported_options_raise(gemma, engine, match):
    _, tcfg, _, tp = gemma
    reqs = [Request(rid=0, tokens=np.zeros(3, np.int64), max_new_tokens=2)]
    with pytest.raises(NotImplementedError, match=match):
        serve_continuous(tp, tcfg, reqs, EngineConfig(**engine),
                         device="cpu")


def test_mesh_raises(gemma):
    _, tcfg, _, tp = gemma
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        serve_continuous(tp, tcfg, [], EngineConfig(paged=True),
                         mesh=object(), device="cpu")


def test_empty_trace_stats_equal_jax(gemma):
    jcfg, tcfg, jp, tp = gemma
    engine = dict(n_slots=3, paged=True, page_size=4, pool_pages=7)
    jr = j_serve(jp, jcfg, [], JEngineConfig(**engine))
    tr = serve_continuous(tp, tcfg, [], EngineConfig(**engine),
                          device="cpu")
    assert tr.stats == jr.stats and tr.tokens == {} and tr.wall_s == 0.0


def test_oversized_request_raises(gemma):
    _, tcfg, _, tp = gemma
    reqs = [Request(rid=0, tokens=np.zeros(6, np.int64), max_new_tokens=8)]
    with pytest.raises(ValueError):
        serve_continuous(tp, tcfg, reqs, EngineConfig(
            n_slots=1, cache_len=10, paged=True), device="cpu")
    with pytest.raises(ValueError):
        serve_continuous(tp, tcfg, reqs, EngineConfig(
            n_slots=2, cache_len=16, paged=True, page_size=4,
            pool_pages=2), device="cpu")


def test_serve_raises_without_cuda_unless_asked(gemma):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    _, tcfg, _, tp = gemma
    reqs = [Request(rid=0, tokens=np.zeros(3, np.int64), max_new_tokens=2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_continuous(tp, tcfg, reqs, EngineConfig(paged=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg, torch.Generator())


# ---------------------------------------------------------------------------
# the device half of the scheduler
# ---------------------------------------------------------------------------

def _prefill_cache(seed, l=2, t=6, kv=2, d=4):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((l, 1, t, kv, d)).astype(np.float32)
            for k in ("k", "v")}


@pytest.mark.parametrize("t", [3, 6, 8, 12])
def test_cache_time_helpers_match_jax(t):
    c = _prefill_cache(0)
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    assert t_sched.cache_len_of(tc) == j_sched.cache_len_of(jc) == 6
    got, want = t_sched.fit_cache_len(tc, t), j_sched.fit_cache_len(jc, t)
    assert t_sched.cache_len_of(got) == t
    for k in c:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    grown = t_sched.grow_cache(tc, 2)
    want = j_sched.grow_cache(jc, 2)
    for k in c:
        np.testing.assert_array_equal(grown[k].numpy(), np.asarray(want[k]))
    assert t_sched.grow_cache(tc, 0) is tc


def test_insert_paged_cache_matches_jax():
    """Pages land in the named physical pages across all layers; the
    pad entry (the scratch page) is not compared."""
    rng = np.random.default_rng(1)
    pool = {k: rng.standard_normal((2, 7, 4, 2, 4)).astype(np.float32)
            for k in ("k", "v")}                      # 6 pages + scratch
    req = t_sched.fit_cache_len(
        {k: torch.from_numpy(v) for k, v in _prefill_cache(2).items()}, 12)
    phys = [4, 1, 6]
    want = j_sched.insert_paged_cache(
        {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v.numpy()) for k, v in req.items()}, phys, 0)
    batch = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    got = t_sched.insert_paged_cache(batch, req, phys, 0)
    assert got is batch
    for k in pool:
        np.testing.assert_array_equal(got[k][:, :6].numpy(),
                                      np.asarray(want[k])[:, :6])


def test_evict_slot_state_leaves_pools_alone():
    pools = {"k": torch.ones(2, 5, 4, 1, 2), "v": torch.ones(2, 5, 4, 1, 2)}
    state = {"attn": dict(pools), "ssd": {"conv": torch.ones(2, 3, 4)}}
    out = t_sched.evict_slot_state(state, 1)
    assert (out["attn"]["k"] == 1).all() and (out["attn"]["v"] == 1).all()
    assert (out["ssd"]["conv"][:, 1] == 0).all()
    assert (out["ssd"]["conv"][:, [0, 2]] == 1).all()


def test_lm_params_from_numpy_unstacks_layers_and_keeps_bf16_bits():
    cfg = dataclasses.replace(j_configs.get_reduced("gemma-2b"),
                              dtype="bfloat16")
    jp = j_init(jax.random.PRNGKey(1), cfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        w = tp["layers"][i]["mixer"]["wq"]
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            w.view(torch.int16).numpy(),
            np.asarray(jp["layers"]["mixer"]["wq"][i]).view(np.int16))
        assert w.untyped_storage().nbytes() == w.numel() * 2  # not a view
    np.testing.assert_array_equal(
        tp["head"].float().numpy(), np.asarray(jp["head"], np.float32))
