"""The prefix cache and speculative serving with the MLA mixer and the
MoE FFN, against the JAX package's own output for the same path
(tests/test_torch_serve_mla_moe.py holds the other serve paths).

At reduced deepseek-v2-236b (MLA + MoE), with JAX's parameters carried
across by ``lm_params_from_numpy``: greedy tokens and stats equal JAX's
through prefix-cache serving (kernel, whose kernel runs its plain
version here, and gather; on and off) and speculative serving (draft
prune rates 0 and 0.5). The prefix cache prefills a suffix as its own
MoE chunk and the verify step batches k+1 queries per slot, so their
tokens may differ from plain serving's, in JAX as here. The MLA cases of
tests/test_serve_prefix.py and tests/test_speculative.py (no MoE) also
hold prefix-cache and speculative tokens to plain serving's. The
self-draft of the MoE model equals JAX's, masks bit-equal, with the
routed expert stacks left dense as JAX leaves them."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core.pruning import CSBSpec as J_CSBSpec
from repro.core.pruning import csb_masks as J_csb_masks
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import derive_draft_params as j_derive
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.pruning import CSBSpec as T_CSBSpec
from repro_torch.core.pruning import csb_masks as T_csb_masks
from repro_torch.models import ModelConfig
from repro_torch.serve import (
    EngineConfig, Request, derive_draft_params, serve_continuous,
)

_TIMED = ("tokens_per_sec", "compile_time_s", "steady_tokens_per_sec")
# tests/test_serve_prefix.py's CFG_MLA, tests/test_speculative.py's MLA
TINY_MLA = dict(name="tiny-prefix-mla", mixer="mla", ffn="swiglu",
                n_layers=2, d_model=32, n_heads=2, n_kv=2, head_dim=16,
                d_ff=64, vocab=50, kv_lora=16, q_lora=16, rope_head_dim=8,
                dtype="float32", logit_chunk=16, remat=False)
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


def _trace(vocab, seed=3, n=6):
    """tests/test_speculative.py's trace: mixed lengths, staggered."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 12))),
             int(rng.integers(3, 9)), (i // 2) * 2) for i in range(n)]


def _shared_trace(vocab, seed=7, sys_len=9, n=6):
    """tests/test_serve_prefix.py's trace: a shared system prompt whose
    divergence lands mid-page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, size=sys_len)
    return [(np.concatenate([sys_p, rng.integers(
        0, vocab, size=int(rng.integers(1, 5)))]), 4, (i // 3) * 2)
        for i in range(n)]


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


def _shared_trace(vocab, seed=7, sys_len=9, n=6):
    """tests/test_serve_prefix.py's trace: a shared system prompt whose
    divergence lands mid-page (copy-on-write)."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, size=sys_len)
    return [(np.concatenate([sys_p, rng.integers(
        0, vocab, size=int(rng.integers(1, 5)))]), 4, (i // 3) * 2)
        for i in range(n)]


# ---------------------------------------------------------------------------
# reduced deepseek-v2-236b
# ---------------------------------------------------------------------------

def test_prefix_serving_matches_jax(deepseek):
    """The suffix is its own MoE chunk, so prefix on and off may differ;
    each equals JAX's run with the same setting."""
    jcfg, tcfg, jp, tp = deepseek
    trace = _shared_trace(jcfg.vocab)
    for prefix in (True, False):
        want = _j_serve(jp, jcfg, trace, **PAGED, prefix_cache=prefix)
        for use_kernel in (False, True):
            got = _serve(tp, tcfg, trace, **PAGED, prefix_cache=prefix,
                         use_kernel=use_kernel)
            _same_run(got, want)
    assert got.stats["prefill_tokens"] > 0
    assert want.stats.get("prefix_hits", 0) == 0
    assert _j_serve(jp, jcfg, trace, **PAGED, prefix_cache=True).stats[
        "prefix_hits"] == len(trace) - 1


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_speculative_serving_matches_jax(deepseek, rate):
    jcfg, tcfg, jp, tp = deepseek
    trace = _trace(jcfg.vocab)
    spec = dict(PAGED, speculative=True, spec_k=3, draft_prune_rate=rate)
    _same_run(_serve(tp, tcfg, trace, **spec),
              _j_serve(jp, jcfg, trace, **spec))


# ---------------------------------------------------------------------------
# the MLA cases of tests/test_serve_prefix.py and tests/test_speculative.py
# ---------------------------------------------------------------------------

def test_tiny_mla_prefix_matches_off_and_jax():
    jcfg, tcfg, jp, tp = _model(TINY_MLA)
    trace = _shared_trace(jcfg.vocab)
    want = _j_serve(jp, jcfg, trace, **PAGED, prefix_cache=True)
    off = _serve(tp, tcfg, trace, **PAGED)
    for use_kernel in (False, True):
        on = _serve(tp, tcfg, trace, **PAGED, prefix_cache=True,
                    use_kernel=use_kernel)
        _same_run(on, want)
        assert on.tokens == off.tokens
    assert on.stats["prefix_hits"] == len(trace) - 1
    assert on.stats["paging"]["cow_copies"] > 0


@pytest.mark.parametrize("k,rate", [(1, 0.5), (3, 0.0), (3, 0.5)])
def test_tiny_mla_speculative_matches_plain_and_jax(k, rate):
    jcfg, tcfg, jp, tp = _model(TINY_MLA, seed=2)
    trace = _trace(jcfg.vocab)
    plain = _serve(tp, tcfg, trace, **PAGED)
    spec = dict(PAGED, speculative=True, spec_k=k, draft_prune_rate=rate)
    got = _serve(tp, tcfg, trace, **spec)
    assert got.tokens == plain.tokens
    if k == 3 and rate == 0.5:
        _same_run(got, _j_serve(jp, jcfg, trace, **spec))


# ---------------------------------------------------------------------------
# the MoE self-draft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_draft_bit_equal_to_jax(dtype):
    """JAX projects the rank-2/3 ``w*`` leaves of its stacked tree: every
    per-layer matrix (rank 3 stacked) of the MLA and the shared experts,
    not the routed expert stacks (rank 4 stacked) nor the router. The
    port's draft equals JAX's value for value, each pruned leaf's masks
    bit-equal to JAX's jitted ones, the expert stacks untouched."""
    jcfg, tcfg, jp, tp = _model("deepseek-v2-236b", dtype=dtype)
    rate = 0.5
    want = lm_params_from_numpy(
        jax.tree.map(np.asarray, j_derive(jp, rate)), device="cpu")
    got = derive_draft_params(tp, rate)
    j_masks = jax.jit(J_csb_masks, static_argnums=1)
    pruned = 0
    for li, (g, w, t) in enumerate(zip(got["layers"], want["layers"],
                                       tp["layers"])):
        for part in ("mixer", "ffn"):
            names = [(n,) for n in g[part] if n != "shared"] + [
                ("shared", n) for n in g[part].get("shared", {})]
            for path in names:
                gl, wl, tl = g[part], w[part], t[part]
                jl = jp["layers"][part]
                for n in path:
                    gl, wl, tl, jl = gl[n], wl[n], tl[n], jl[n]
                assert gl.dtype == wl.dtype == tl.dtype, path
                assert torch.equal(gl, wl), (li, part, path)
                if path[-1] in ("w_gate", "w_up", "w_down") \
                        and path[0] != "shared":
                    assert gl is tl             # routed experts stay dense
                    continue
                if not path[-1].startswith("w"):
                    continue
                for t_m, j_m in zip(
                        T_csb_masks(tl, T_CSBSpec(prune_rate=rate)),
                        j_masks(jl[li], J_CSBSpec(prune_rate=rate))):
                    np.testing.assert_array_equal(t_m.numpy(),
                                                  np.asarray(j_m))
                pruned += 1
    # per layer: the 6 MLA matrices and the 3 shared-expert matrices
    assert pruned == 9 * tcfg.n_layers
