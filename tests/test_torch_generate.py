"""Port of serve/engine.py's ``generate`` and contiguous-cache
``serve_continuous``, the contiguous decode of models/layers.py
(``_cache_write``, ``attn_decode``, ``attn_cache_init``) and
models/lm.py (``decode_step``, ``init_cache``), and serve/scheduler.py's
contiguous slot ops (``insert_slot_cache``, ``evict_slot``).

The JAX package's parameters (through ``lm_params_from_numpy``) and the
same numpy-seeded inputs go through both packages, for reduced gemma-2b
and tests/test_speculative.py's tiny ``CFG`` and windowed ``WIN``:
greedy tokens are identical, logits and caches agree at 2e-5 (fp32
summation order, as in slice 2), and the cache write clamps its start
exactly where JAX's ``dynamic_update_slice`` does."""
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
from repro.serve import Request as JRequest
from repro.serve import generate as j_generate
from repro.serve import scheduler as j_sched
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.serve import (
    EngineConfig, Request, generate, serve_continuous,
)
from repro_torch.serve import scheduler as t_sched

CFG = dict(name="tiny-spec", mixer="attn", ffn="swiglu", n_layers=2,
           d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=50,
           dtype="float32", logit_chunk=16, remat=False)
WIN = dict(CFG, name="tiny-spec-win", window=6)
CFGS = {"gemma-2b-reduced": None, "attn": CFG, "win": WIN}
TOL = 2e-5
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
    return _model(request.param)


@pytest.fixture(scope="module")
def gemma():
    return _model("gemma-2b-reduced")


def _prompts(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_new,cache_len", [(6, None), (1, None),
                                               (5, 40)])
def test_generate_greedy_equals_jax(model, max_new, cache_len):
    jcfg, tcfg, jp, tp = model
    prompt = _prompts(jcfg.vocab, (2, 8), 1)
    engine = dict(max_new_tokens=max_new, cache_len=cache_len)
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(prompt),
                                 JEngineConfig(**engine)))
    got = generate(tp, tcfg, prompt, EngineConfig(**engine), device="cpu")
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 8 + max_new)
    np.testing.assert_array_equal(got.numpy(), want)
    again = generate(tp, tcfg, torch.as_tensor(prompt),
                     EngineConfig(**engine), device="cpu")
    assert torch.equal(got, again)


def test_generate_matches_teacher_forcing(model):
    """Greedy generation agrees with a prefill of the grown sequence at
    every step (cache correctness through the decode loop). The decode
    step applies the config's window; the prefill takes it as an
    argument (``generate``'s own prefill runs unwindowed, as JAX's does,
    which a 6-token prompt under ``WIN``'s window of 6 cannot tell)."""
    jcfg, tcfg, _, tp = model
    prompt = _prompts(jcfg.vocab, (1, 6), 4)
    out = generate(tp, tcfg, prompt, EngineConfig(max_new_tokens=4),
                   device="cpu").numpy()
    seq = prompt
    for i in range(4):
        logits, _ = TLM.prefill(tp, {"tokens": torch.as_tensor(seq)}, tcfg,
                                window=tcfg.window)
        nxt = int(torch.argmax(logits[0]))
        assert nxt == out[0, 6 + i], (i, nxt, out)
        seq = np.concatenate([seq, [[nxt]]], axis=1)


def test_generate_temperature_draws_from_the_generator(gemma):
    _, tcfg, _, tp = gemma
    prompt = _prompts(tcfg.vocab, (2, 5), 14)
    cfg = EngineConfig(max_new_tokens=6, temperature=0.8)

    def run(seed):
        return generate(tp, tcfg, prompt, cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    a = run(0)
    assert torch.equal(a, run(0))
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab
    assert any(not torch.equal(run(s), a) for s in (1, 2, 3))


@pytest.mark.parametrize("arch,match", [("musicgen-medium", "single-stream"),
                                        ("internvl2-2b", "img_embeds")])
def test_generate_rejects_unported_frontends(gemma, arch, match):
    """What ``generate`` still rejects of the frontends, as JAX's does
    (tests/test_torch_frontends.py holds both packages to it): a codebook
    model's speculative path, and an image-token model, whose prefill
    would need the ``img_embeds`` that ``generate`` does not pass."""
    _, _, _, tp = gemma
    with pytest.raises(NotImplementedError, match=match):
        generate(tp, t_configs.get_reduced(arch), np.zeros((1, 3), np.int64),
                 EngineConfig(speculative=True), device="cpu")


def test_generate_mesh_raises(gemma):
    """``mesh=`` takes a DeviceMesh (tests/test_torch_serve_mesh*.py
    generate on one); anything else raises."""
    _, tcfg, _, tp = gemma
    with pytest.raises(TypeError, match="DeviceMesh"):
        generate(tp, tcfg, np.zeros((1, 3), np.int64), mesh=object(),
                 device="cpu")


def test_generate_raises_without_cuda_unless_asked(gemma):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    _, tcfg, _, tp = gemma
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tp, tcfg, np.zeros((1, 3), np.int64))


# ---------------------------------------------------------------------------
# the contiguous decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos,s", [
    (7, 3),                 # pos = T - 1 with s = 3: start clamps to T - s
    (2, 3),                 # inside the buffer
    (-2, 1),                # negative: counts once from the end
    (-20, 3),               # still negative from the end: clamps to 0
    ([7, 0, 4, 6], 3),      # per row: clamped, in range, in range, clamped
    ([5, -1, 3, -9], 2),
])
def test_cache_write_clamps_like_jax(pos, s):
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((4, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((4, s, 2, 4)).astype(np.float32)
    jpos = jnp.asarray(pos, jnp.int32)
    want = JL._cache_write(jnp.asarray(buf), jnp.asarray(new), jpos)
    tbuf = torch.from_numpy(buf.copy())
    got = TL._cache_write(tbuf, torch.from_numpy(new),
                          torch.as_tensor(pos))
    assert got is tbuf                       # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("pos", [4, (0, 5, 10)], ids=["scalar", "per-row"])
def test_attn_decode_matches_jax(model, s, pos):
    """One layer's contiguous decode, s = 1 and the s = 3 verify shape,
    scalar and per-row positions (the last row's overhang clamps)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(5)
    b, t = 3, 12
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cache = {k: rng.standard_normal((b, t, jcfg.n_kv, jcfg.hd)).astype(
        np.float32) for k in ("k", "v")}
    jlp = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    jo, jc = JL.attn_decode(jlp, jnp.asarray(x), jcfg,
                            {k: jnp.asarray(v) for k, v in cache.items()},
                            jnp.asarray(pos, jnp.int32))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    to, tc2 = TL.attn_decode(tp["layers"][0]["mixer"], torch.from_numpy(x),
                             tcfg, tc, torch.as_tensor(pos))
    assert tc2["k"] is tc["k"] and tc2["v"] is tc["v"]
    _close(to, jo)
    for k in cache:
        _close(tc2[k], jc[k])


def test_attn_cache_init_equals_jax():
    jcfg, tcfg = JModelConfig(**CFG), ModelConfig(**CFG)
    want = JL.attn_cache_init(jcfg, 3, 7, jnp.float32)
    got = TL.attn_cache_init(tcfg, 3, 7, torch.float32, "cpu")
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape
        assert not got[k].any()


def test_decode_step_matches_jax(model):
    """Prefill, then four contiguous decode steps with per-slot
    positions: logits and caches agree with JAX's at every step."""
    jcfg, tcfg, jp, tp = model
    prompt = _prompts(jcfg.vocab, (2, 6), 6)
    jl, jcache = JLM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg)
    jcache = j_sched.grow_cache(jcache, 6)
    tl, tcache = TLM.prefill(tp, {"tokens": torch.as_tensor(prompt)}, tcfg)
    tcache = t_sched.grow_cache(tcache, 6)
    _close(tl, jl)
    want_init = JLM.init_cache(jcfg, 2, 12, jnp.float32)
    got_init = TLM.init_cache(tcfg, 2, 12, torch.float32, "cpu")
    for k in ("k", "v"):
        _close(tcache[k], jcache[k])
        assert tuple(got_init[k].shape) == want_init[k].shape
        assert tuple(tcache[k].shape) == want_init[k].shape
    pos = np.asarray([6, 4])
    cur = np.argmax(np.asarray(jl), -1)[:, None]
    for _ in range(4):
        jl, jcache = JLM.decode_step(jp, jcache, jnp.asarray(cur),
                                     jnp.asarray(pos, jnp.int32), jcfg)
        tl, tcache2 = TLM.decode_step(tp, tcache, torch.as_tensor(cur),
                                      torch.as_tensor(pos), tcfg)
        assert tcache2 is tcache
        _close(tl, jl)
        for k in ("k", "v"):
            _close(tcache[k], jcache[k])
        cur = np.argmax(np.asarray(jl)[:, -1], -1)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# contiguous serve_continuous
# ---------------------------------------------------------------------------

MIXED = dict(lens=(4, 8, 5, 7, 6, 11), max_new=(4, 6, 5, 4, 6, 3),
             arrivals=(0, 0, 3, 6, 6, 9))


def _trace(vocab, lens, max_new, arrivals, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=n), m, a)
            for n, m, a in zip(lens, max_new, arrivals)]


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


@pytest.mark.parametrize("bucket", [None, True], ids=["exact", "bucketed"])
def test_contiguous_serve_equals_jax_and_paged(model, bucket):
    jcfg = model[0]
    trace = _trace(jcfg.vocab, seed=5, **MIXED)
    jr, tr = _serve_both(model, trace, n_slots=2, bucket_prompts=bucket)
    assert tr.tokens == jr.tokens
    assert not tr.stats["paged"]
    assert set(tr.stats) == set(jr.stats)
    for k, v in jr.stats.items():
        if k not in _TIMED:
            assert tr.stats[k] == v, k
    _, paged = _serve_both(model, trace, n_slots=2, paged=True, page_size=4)
    assert paged.tokens == tr.tokens


def test_contiguous_serve_equals_generate(gemma):
    """Each request of a contiguous run decodes as ``generate`` decodes
    it alone (vector positions against a scalar position)."""
    jcfg, tcfg, _, tp = gemma
    trace = _trace(jcfg.vocab, (5, 9, 3), (4, 3, 5), (0, 1, 1), 8)
    res = serve_continuous(tp, tcfg, [
        Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], EngineConfig(n_slots=2),
        device="cpu")
    for i, (p, m, _) in enumerate(trace):
        ref = generate(tp, tcfg, p[None], EngineConfig(max_new_tokens=m),
                       device="cpu")
        assert res.tokens[i] == ref[0, len(p):].tolist()


def test_paged_outadmits_contiguous_on_same_budget(model):
    """tests/test_serve_paged.py's admission test: one long and four
    short requests on a budget of 80 cache tokens. The contiguous engine
    carves it into 2 max-length slots and queues; the paged pool reserves
    per-request pages and runs 3+ requests at once — with ``generate``'s
    tokens, and JAX's stats, in both."""
    jcfg, tcfg, jp, tp = model
    psz, cache_len, budget = 8, 40, 80
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab, size=8) for _ in range(5)]
    trace = list(zip(prompts, [32, 8, 8, 8, 8], [0] * 5))
    _, paged = _serve_both(model, trace, n_slots=4, paged=True,
                           page_size=psz, cache_len=cache_len,
                           pool_pages=budget // psz)
    jr, contig = _serve_both(model, trace, n_slots=budget // cache_len,
                             cache_len=cache_len)
    assert contig.tokens == jr.tokens == paged.tokens
    for i, (p, m, _) in enumerate(trace):
        ref = generate(tp, tcfg, p[None], EngineConfig(max_new_tokens=m),
                       device="cpu")
        assert paged.tokens[i] == ref[0, len(p):].tolist()
    assert contig.stats["peak_active"] == jr.stats["peak_active"] == 2
    assert paged.stats["peak_active"] >= 3
    assert paged.stats["paging"]["peak_pages"] <= budget // psz


def test_contiguous_empty_trace_stats_equal_jax(gemma):
    jcfg, tcfg, jp, tp = gemma
    jr = j_serve(jp, jcfg, [], JEngineConfig(n_slots=3))
    tr = serve_continuous(tp, tcfg, [], EngineConfig(n_slots=3),
                          device="cpu")
    assert tr.stats == jr.stats and tr.tokens == {}


# ---------------------------------------------------------------------------
# contiguous slot ops
# ---------------------------------------------------------------------------

def test_insert_and_evict_slot_cache_match_jax():
    rng = np.random.default_rng(2)
    batch = {k: rng.standard_normal((2, 3, 8, 2, 4)).astype(np.float32)
             for k in ("k", "v")}
    req = {k: rng.standard_normal((2, 1, 5, 2, 4)).astype(np.float32)
           for k in ("k", "v")}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    want = j_sched.insert_slot_cache(
        jb, {k: jnp.asarray(v) for k, v in req.items()}, 1)
    got = t_sched.insert_slot_cache(
        tb, {k: torch.from_numpy(v) for k, v in req.items()}, 1)
    assert got is tb
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    want = j_sched.evict_slot(want, 2)
    got = t_sched.evict_slot(got, 2)
    assert got is tb
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert not got[k][:, 2].any()


def test_lm_params_keep_bf16_through_generate():
    """bf16 weights run the contiguous path end to end (caches in bf16)."""
    jcfg = dataclasses.replace(j_configs.get_reduced("gemma-2b"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(t_configs.get_reduced("gemma-2b"),
                               dtype="bfloat16")
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = _prompts(jcfg.vocab, (2, 5), 9)
    cache = TLM.init_cache(tcfg, 2, 9, torch.bfloat16, "cpu")
    assert cache["k"].dtype == torch.bfloat16
    out = generate(tp, tcfg, prompt, EngineConfig(max_new_tokens=4),
                   device="cpu")
    assert tuple(out.shape) == (2, 9)
    assert int(out.min()) >= 0 and int(out.max()) < tcfg.vocab
