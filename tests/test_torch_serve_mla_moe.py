"""The serve paths with the MLA mixer and the MoE FFN: models/lm.py's MLA
and MoE branches (prefill, partial prefill, the contiguous and paged
decode steps, both caches) and paged, contiguous and ``generate``
serving over them, against the JAX package's own output for the same
path (tests/test_torch_prefix_spec_mla_moe.py holds the prefix cache and
speculative serving).

At reduced deepseek-v2-236b (MLA + MoE) and reduced llama4-scout
(attention + top-1 MoE), with JAX's parameters carried across by
``lm_params_from_numpy``: prefill logits and cache, the partial
prefill, and the decode steps' logits and caches agree at 2e-5 (the
bound of tests/test_paged_attn.py's kernel-vs-gather test); greedy
tokens and stats equal JAX's through paged serving (kernel, whose kernel
runs its plain version here, and gather), contiguous serving and
``generate``. The MoE makes a token depend on the tokens batched with it
(capacity per chunk), in JAX as here, so each path is held to JAX's run
of the same path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ModelConfig as JModelConfig
from repro.models import decode_step as j_decode
from repro.models import decode_step_paged as j_decode_paged
from repro.models import init_cache as j_cache
from repro.models import init_paged_cache as j_paged_cache
from repro.models import init_params as j_init
from repro.models import lm as JLM
from repro.models import prefill as j_prefill
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import PagePool as JPagePool
from repro.serve import Request as JRequest
from repro.serve import generate as j_generate
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (
    ModelConfig, decode_step, decode_step_paged, init_cache,
    init_paged_cache, prefill, prefill_partial,
)
from repro_torch.serve import (
    EngineConfig, PagePool, Request, generate, serve_continuous,
)

TOL = 2e-5
_TIMED = ("tokens_per_sec", "compile_time_s", "steady_tokens_per_sec")
PAGED = dict(n_slots=2, paged=True, page_size=4)


def _model(spec, seed=0, dtype="float32"):
    if isinstance(spec, str):
        jcfg, tcfg = j_configs.get_reduced(spec), t_configs.get_reduced(spec)
    else:
        jcfg, tcfg = JModelConfig(**spec), ModelConfig(**spec)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def deepseek():
    return _model("deepseek-v2-236b")


@pytest.fixture(scope="module", params=["deepseek-v2-236b",
                                        "llama4-scout-17b-a16e"])
def moe_model(request):
    return _model(request.param)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


def _trace(vocab, seed=3, n=6):
    """tests/test_speculative.py's trace: mixed lengths, staggered."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 12))),
             int(rng.integers(3, 9)), (i // 2) * 2) for i in range(n)]


def _serve(tp, tcfg, trace, **engine):
    return serve_continuous(tp, tcfg, [
        Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], EngineConfig(**engine),
        device="cpu")


def _j_serve(jp, jcfg, trace, **engine):
    return j_serve(jp, jcfg, [
        JRequest(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], JEngineConfig(**engine))


def _same_run(got, want):
    assert got.tokens == {k: list(v) for k, v in want.tokens.items()}
    assert set(got.stats) == set(want.stats)
    for k, v in want.stats.items():
        if k not in _TIMED:
            assert got.stats[k] == v, k


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last_pos", [None, 7])
def test_prefill_matches_jax(moe_model, last_pos):
    jcfg, tcfg, jp, tp = moe_model
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, size=(2, 13))
    jl, jc = jax.jit(lambda p, t: j_prefill(p, {"tokens": t}, jcfg,
                                            last_pos=last_pos))(
        jp, jnp.asarray(toks))
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                     last_pos=last_pos)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k])


def test_prefill_partial_matches_jax(deepseek):
    """A suffix at positions 9..14 against the first 9 positions' latent
    cache, padded to 12 (three pages of 4)."""
    jcfg, tcfg, jp, tp = deepseek
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, size=(1, 15))
    _, full = jax.jit(lambda p, t: j_prefill(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    ctx = {k: np.pad(np.asarray(v)[:, :, :9],
                     [(0, 0), (0, 0), (0, 3)] + [(0, 0)] * (v.ndim - 3))
           for k, v in full.items()}
    suffix = toks[:, 9:]
    jl, jc = jax.jit(lambda p, t, c: JLM.prefill_partial(
        p, {"tokens": t}, c, jcfg, start=9, last_pos=4))(
        jp, jnp.asarray(suffix), {k: jnp.asarray(v) for k, v in ctx.items()})
    tl, tc = prefill_partial(tp, {"tokens": torch.from_numpy(suffix)},
                             {k: torch.from_numpy(v) for k, v in
                              ctx.items()}, tcfg, start=9, last_pos=4)
    _close(tl, jl)
    for k in jc:
        _close(tc[k], jc[k])


def _paged_state(jcfg, tcfg, pos_list, psz=4, n_pages=10, max_pages=3):
    n_slots = len(pos_list)
    jpool = JPagePool(psz, n_pages, n_slots, max_pages)
    tpool = PagePool(psz, n_pages, n_slots, max_pages, device="cpu")
    for s, p in enumerate(pos_list):
        for pool in (jpool, tpool):
            pool.reserve(s, max_pages * psz)
            pool.ensure(s, int(p) + 1)
    rng = np.random.default_rng(11)
    want = j_paged_cache(jcfg, n_pages, psz, n_slots, jnp.float32)
    got = init_paged_cache(tcfg, n_pages, psz, n_slots, torch.float32,
                           "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: v.shape for k, v in want.items()}
    return jpool, tpool, {k: rng.standard_normal(v.shape).astype(np.float32)
                          for k, v in want.items()}


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
@pytest.mark.parametrize("vec", [False, True],
                         ids=["scalar-pos", "vector-pos"])
def test_decode_step_paged_matches_jax(moe_model, use_kernel, vec):
    jcfg, tcfg, jp, tp = moe_model
    pos_list = [7, 2, 10] if vec else [7, 7, 7]
    jpool, tpool, arrays = _paged_state(jcfg, tcfg, pos_list)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, size=(3, 1))
    pos = np.asarray(pos_list, np.int32) if vec else 7
    jl, jc = jax.jit(lambda p, c, t, q, tab: j_decode_paged(
        p, c, t, q, tab, jcfg, use_kernel=use_kernel))(
        jp, {k: jnp.asarray(v) for k, v in arrays.items()},
        jnp.asarray(toks), jnp.asarray(pos), jpool.device_table())
    cache = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    tl, tc = decode_step_paged(tp, cache, torch.from_numpy(toks),
                               torch.as_tensor(pos), tpool.device_table(),
                               tcfg, use_kernel=use_kernel)
    assert tc is cache
    _close(tl, jl)
    mapped = sorted({p for s in range(3) for p in tpool.slot_pages(s)})
    for k in arrays:
        _close(tc[k][:, mapped], np.asarray(jc[k])[:, mapped])


@pytest.mark.parametrize("vec", [False, True],
                         ids=["scalar-pos", "vector-pos"])
def test_decode_step_matches_jax(deepseek, vec):
    jcfg, tcfg, jp, tp = deepseek
    shapes = {k: v.shape for k, v in j_cache(jcfg, 3, 12,
                                             jnp.float32).items()}
    assert {k: tuple(v.shape) for k, v in init_cache(
        tcfg, 3, 12, torch.float32, "cpu").items()} == shapes
    rng = np.random.default_rng(13)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    toks = rng.integers(0, jcfg.vocab, size=(3, 1))
    pos = np.asarray([7, 2, 10], np.int32) if vec else 9
    jl, jc = jax.jit(lambda p, c, t, q: j_decode(p, c, t, q, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in arrays.items()},
        jnp.asarray(toks), jnp.asarray(pos))
    cache = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    tl, _ = decode_step(tp, cache, torch.from_numpy(toks),
                        torch.as_tensor(pos), tcfg)
    _close(tl, jl)
    for k in arrays:
        _close(cache[k], jc[k])


# ---------------------------------------------------------------------------
# greedy tokens through every serve path, against JAX's same path
# ---------------------------------------------------------------------------

def test_paged_serving_matches_jax(moe_model):
    """Kernel and gather give JAX's tokens and stats (JAX's kernel and
    gather paths are token-identical, tests/test_paged_attn.py)."""
    jcfg, tcfg, jp, tp = moe_model
    trace = _trace(jcfg.vocab)
    want = _j_serve(jp, jcfg, trace, **PAGED)
    for use_kernel in (False, True):
        _same_run(_serve(tp, tcfg, trace, **PAGED, use_kernel=use_kernel),
                  want)


def test_contiguous_serving_matches_jax(deepseek):
    jcfg, tcfg, jp, tp = deepseek
    trace = _trace(jcfg.vocab, seed=4)
    _same_run(_serve(tp, tcfg, trace, n_slots=2),
              _j_serve(jp, jcfg, trace, n_slots=2))


def test_generate_matches_jax(deepseek):
    """Two prompts prefilled together: one MoE chunk, as in JAX."""
    jcfg, tcfg, jp, tp = deepseek
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, size=(2, 9))
    want = j_generate(jp, jcfg, jnp.asarray(prompts),
                      JEngineConfig(max_new_tokens=6))
    got = generate(tp, tcfg, prompts, EngineConfig(max_new_tokens=6),
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
