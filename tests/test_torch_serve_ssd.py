"""The serve paths with the SSD and hybrid mixers: paged serving (through
the paged-attention kernel, whose kernel runs its plain version here,
and the gather path), contiguous serving and ``generate``, against the
JAX package's run of the same path, and the scheduler's per-slot state
writes.

Reduced mamba2-370m (SSD, ``ffn="none"``: the paged pool holds no time
leaf and the kernel never runs) and hymba-1.5b (attention + SSD heads,
a nested cache), hymba also with the MoE FFN, with JAX's ``PRNGKey(0)``
parameters carried across by ``lm_params_from_numpy``: greedy tokens and
stats equal JAX's. Bucketing and the prefix cache switch themselves off
for these mixers, in JAX as here. Each path keeps JAX's state precision:
``generate`` carries the prefill's fp32 SSM state, serving rounds it to
the config's bf16 ``ssd_state_dtype`` on insertion.

Prompts shorter than ``conv_k - 1`` = 3 tokens leave a 1-row conv state
(JAX's ``_ssd_prefill``); serving writes it at the slot's start, as
JAX's ``dynamic_update_slice`` does, and JAX's ``generate`` raises on
it, as the port's does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import init_params as j_init
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import generate as j_generate
from repro.serve import scheduler as j_sched
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import paged_attn
from repro_torch.serve import (
    EngineConfig, Request, generate, serve_continuous,
)
from repro_torch.serve import scheduler as t_sched

_TIMED = ("tokens_per_sec", "compile_time_s", "steady_tokens_per_sec")
PAGED = dict(n_slots=2, paged=True, page_size=4)
MOE = dict(ffn="moe", n_experts=4, top_k=2, moe_dff=64)
MODELS = {"mamba2": ("mamba2-370m", {}),
          "hymba": ("hymba-1.5b", {}),
          "hybrid-moe": ("hymba-1.5b", MOE)}


def _model(name):
    arch, over = MODELS[name]
    jcfg = dataclasses.replace(j_configs.get_reduced(arch), **over)
    tcfg = dataclasses.replace(t_configs.get_reduced(arch), **over)
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def hymba():
    return _model("hymba")


def _trace(vocab, lens=(5, 9, 5, 12), seed=3):
    """Mixed lengths, staggered arrivals; few distinct lengths (every
    prompt length is its own prefill shape: no bucketing here)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=n), 3 + i % 3, (i // 2) * 2)
            for i, n in enumerate(lens)]


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
# the scheduler's writes of per-slot state (C4)
# ---------------------------------------------------------------------------

def _hybrid_batch(rng, l=2, slots=3, n_pool=7, psz=4):
    """A hybrid-shaped paged batch cache: KV pools and per-slot conv (3
    rows) and SSM states, random, as numpy arrays."""
    r = rng.standard_normal
    return {"attn": {k: r((l, n_pool, psz, 2, 4)).astype(np.float32)
                     for k in ("k", "v")},
            "ssd": {"conv": r((l, slots, 3, 5)).astype(np.float32),
                    "ssm": r((l, slots, 2, 3, 4)).astype(np.float32)}}


def _request(rng, rows, t, l=2):
    r = rng.standard_normal
    return {"attn": {k: r((l, 1, t, 2, 4)).astype(np.float32)
                     for k in ("k", "v")},
            "ssd": {"conv": r((l, 1, rows, 5)).astype(np.float32),
                    "ssm": r((l, 1, 2, 3, 4)).astype(np.float32)}}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree))


def _equal(got, want):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=str(path))


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("op", ["insert_paged_cache", "insert_paged_span",
                                "insert_slot_cache"])
def test_state_insert_equals_jax(op, rows):
    """A conv state of 1, 2 or 3 rows lands at the slot's start (JAX's
    ``dynamic_update_slice``); the rows after it keep what the slot held.
    Time leaves go to their pages (the span: positions 6..11 of a row of
    three pages, the last two positions padding)."""
    rng = np.random.default_rng(rows)
    if op == "insert_slot_cache":
        batch = _hybrid_batch(rng)
        batch["attn"] = {k: rng.standard_normal((2, 3, 12, 2, 4)).astype(
            np.float32) for k in ("k", "v")}
        args = (_request(rng, rows, 8), 1)
    elif op == "insert_paged_cache":
        batch = _hybrid_batch(rng)
        args = (_request(rng, rows, 8), [4, 1], 1)
    else:
        batch = _hybrid_batch(rng)
        args = (_request(rng, rows, 8), [2, 5, 6], 6, 6, 1)
    jb, tb = _both(batch)
    jreq, treq = _both(args[0])
    want = getattr(j_sched, op)(jb, jreq, *args[1:])
    got = getattr(t_sched, op)(tb, treq, *args[1:])
    assert got is tb
    _equal(got, want)
    np.testing.assert_array_equal(got["ssd"]["conv"][:, 1, rows:].numpy(),
                                  batch["ssd"]["conv"][:, 1, rows:])


# ---------------------------------------------------------------------------
# greedy tokens through every serve path, against JAX's same path
# ---------------------------------------------------------------------------

def test_paged_serving_matches_jax(model):
    """Kernel and gather give JAX's tokens and stats; mamba2's paged pool
    holds no time leaf, and the kernel never launches (it runs its plain
    version here, where the launch count stays 0 on every path)."""
    jcfg, tcfg, jp, tp = model
    trace = _trace(jcfg.vocab)
    want = _j_serve(jp, jcfg, trace, **PAGED)
    assert want.stats["bucketed_prefill"] is False
    for use_kernel in (False, True):
        before = paged_attn.LAUNCHES
        _same_run(_serve(tp, tcfg, trace, **PAGED, use_kernel=use_kernel),
                  want)
        assert paged_attn.LAUNCHES == before


def test_contiguous_serving_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    trace = _trace(jcfg.vocab, seed=4)
    _same_run(_serve(tp, tcfg, trace, n_slots=2),
              _j_serve(jp, jcfg, trace, n_slots=2))


def test_generate_matches_jax(model):
    """The prefill's fp32 SSM state carried through the decode loop."""
    jcfg, tcfg, jp, tp = model
    prompts = np.random.default_rng(5).integers(0, jcfg.vocab, size=(2, 9))
    want = j_generate(jp, jcfg, jnp.asarray(prompts),
                      JEngineConfig(max_new_tokens=6))
    got = generate(tp, tcfg, prompts, EngineConfig(max_new_tokens=6),
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# prompts shorter than the conv's history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", [dict(PAGED, use_kernel=True),
                                    dict(n_slots=2)],
                         ids=["paged", "contiguous"])
def test_short_prompts_serve_like_jax(hymba, engine):
    """Prompts of 1, 2 and 3 tokens (and one longer, so that a slot is
    reused): a 1-row conv state inserted at the slot's start, in JAX and
    here; the tokens and stats equal JAX's."""
    jcfg, tcfg, jp, tp = hymba
    rng = np.random.default_rng(6)
    trace = [(rng.integers(0, jcfg.vocab, size=n), 4, a)
             for n, a in ((1, 0), (2, 0), (3, 2), (7, 3))]
    _same_run(_serve(tp, tcfg, trace, **engine),
              _j_serve(jp, jcfg, trace, **engine))


@pytest.mark.parametrize("s", [1, 2, 3])
def test_generate_short_prompts_like_jax(hymba, s):
    """JAX's ``generate`` raises on a 1- or 2-token prompt (the decode's
    conv history comes out short: an einsum size mismatch); so does the
    port's. From 3 tokens on, both decode."""
    jcfg, tcfg, jp, tp = hymba
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab, size=(1, s))
    cfg = dict(max_new_tokens=3)
    if s < jcfg.conv_k - 1:
        with pytest.raises(ValueError, match="does not match"):
            j_generate(jp, jcfg, jnp.asarray(prompts), JEngineConfig(**cfg))
        with pytest.raises(RuntimeError):
            generate(tp, tcfg, prompts, EngineConfig(**cfg), device="cpu")
        return
    want = j_generate(jp, jcfg, jnp.asarray(prompts), JEngineConfig(**cfg))
    got = generate(tp, tcfg, prompts, EngineConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
