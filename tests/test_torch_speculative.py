"""Port of serve/speculative.py: the CSB-pruned self-draft, the
rejection sampler, speculative ``generate`` and speculative
``serve_continuous``.

The JAX package's parameters (through ``lm_params_from_numpy``) go
through both packages, for reduced gemma-2b and tests/test_speculative.py's
tiny ``CFG`` and windowed ``WIN``: the port's draft, derived from the
converted target, has masks bit-equal to JAX's draft in fp32 and bf16,
and at temperature 0 the speculative tokens equal JAX's and the plain
engine's for spec_k 1, 2, 4 and prune rates 0, 0.5. JAX keys its draws
with ``jax.random``, which torch cannot reproduce, so at temperature > 0
the port is held to its own spec_k-invariance instead. The MLA case of
tests/test_speculative.py is in tests/test_torch_prefix_spec_mla_moe.py;
its mesh cases wait for the port of meshes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import CSBSpec as J_CSBSpec
from repro.core import csb_masks as J_csb_masks
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import derive_draft_params as j_derive
from repro.serve import generate as j_generate
from repro.serve import serve_continuous as j_serve
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import CSBSpec as T_CSBSpec
from repro_torch.core import csb_masks as T_csb_masks
from repro_torch.models import ModelConfig
from repro_torch.serve import (
    EngineConfig, PagePool, Request, derive_draft_params, generate,
    serve_continuous,
)
from repro_torch.serve.speculative import _commit_round

CFG = dict(name="tiny-spec", mixer="attn", ffn="swiglu", n_layers=2,
           d_model=32, n_heads=2, n_kv=2, head_dim=16, d_ff=64, vocab=50,
           dtype="float32", logit_chunk=16, remat=False)
WIN = dict(CFG, name="tiny-spec-win", window=6)
CFGS = {"gemma-2b-reduced": None, "attn": CFG, "win": WIN}
PAGED = dict(n_slots=2, paged=True, page_size=4)
KS_RATES = [(1, 0.0), (1, 0.5), (2, 0.0), (2, 0.5), (4, 0.0), (4, 0.5)]
_TIMED = ("tokens_per_sec", "compile_time_s", "steady_tokens_per_sec")


def _model(name, dtype="float32"):
    spec = CFGS[name]
    if spec is None:
        jcfg = j_configs.get_reduced("gemma-2b", dtype=dtype)
        tcfg = t_configs.get_reduced("gemma-2b", dtype=dtype)
    else:
        jcfg = JModelConfig(**dict(spec, dtype=dtype))
        tcfg = ModelConfig(**dict(spec, dtype=dtype))
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def tiny():
    return _model("attn")


def _trace(vocab, seed=3, n=6):
    """tests/test_speculative.py's trace."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 12))),
             int(rng.integers(3, 9)), (i // 2) * 2) for i in range(n)]


def _serve(tp, tcfg, trace, generator=None, **engine):
    return serve_continuous(tp, tcfg, [
        Request(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], EngineConfig(**engine),
        generator=generator, device="cpu")


def _j_serve(jp, jcfg, trace, **engine):
    return j_serve(jp, jcfg, [
        JRequest(rid=i, tokens=p, max_new_tokens=m, arrival=a)
        for i, (p, m, a) in enumerate(trace)], JEngineConfig(**engine))


def _spec(k, rate, base=PAGED, **kw):
    return dict(base, speculative=True, spec_k=k, draft_prune_rate=rate,
                **kw)


# ---------------------------------------------------------------------------
# the self-draft
# ---------------------------------------------------------------------------

def test_derive_draft_rate0_is_the_target_itself(tiny):
    _, _, _, tp = tiny
    assert derive_draft_params(tp, 0.0) is tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.3, 0.5, 0.9])
def test_derive_draft_bit_equal_to_jax(dtype, rate):
    """The draft derived in the port from the converted target equals the
    draft JAX derives from its own target (per-layer 2-D leaves against
    JAX's per-layer vmap over the stacked leaves): every value equal, and
    each pruned leaf's row and column masks bit-equal to those of JAX's
    jitted projection. (A pruned entry is +0.0 in JAX and may be -0.0
    here: the values compare equal, their bits need not.)"""
    jcfg, tcfg, jp, tp = _model("gemma-2b-reduced", dtype)
    want = lm_params_from_numpy(
        jax.tree.map(np.asarray, j_derive(jp, rate)), device="cpu")
    got = derive_draft_params(tp, rate)
    tspec = T_CSBSpec(prune_rate=rate)
    j_masks = jax.jit(J_csb_masks, static_argnums=1)

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, t

    pairs = list(zip(leaves(got), leaves(want)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    pruned = 0
    for (path, g), (_, w) in pairs:
        assert g.dtype == w.dtype == getattr(torch, dtype), path
        assert torch.equal(g, w), path
        if not path.split("/")[-1].startswith("w"):
            continue
        _, _, li, part, name = path.split("/")
        leaf = tp["layers"][int(li)][part][name]
        jleaf = jp["layers"][part][name][int(li)]
        for t_m, j_m in zip(T_csb_masks(leaf, tspec),
                            j_masks(jleaf, J_CSBSpec(prune_rate=rate))):
            np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
        pruned += 1
    assert pruned == 7 * tcfg.n_layers


def test_derive_draft_prunes_weights_only(tiny):
    _, _, _, tp = tiny
    draft = derive_draft_params(tp, 0.6)
    pruned = kept = 0
    for lp, dp in zip(tp["layers"], draft["layers"]):
        for part in ("mixer", "ffn"):
            for name, w in lp[part].items():
                d = dp[part][name]
                assert name.startswith("w")
                # the projection zeroes mass; survivors keep their values
                assert (d == 0).float().mean() > 0.2, name
                nz = d != 0
                assert torch.equal(d[nz], w[nz])
                pruned += 1
        for name in ("norm1", "norm2"):
            assert dp[name] is lp[name]
            kept += 1
    for name in ("embed", "final_norm"):
        assert draft[name] is tp[name]
        kept += 1
    assert pruned == 7 * len(tp["layers"]) and kept > 0


# ---------------------------------------------------------------------------
# rejection-sampler unit behaviour
# ---------------------------------------------------------------------------

def test_all_rejected_round_still_commits_target_token():
    v, k = 8, 3
    pi = np.full((k + 1, v), -10.0, np.float32)
    pi[:, 5] = 10.0                      # target argmax is 5 everywhere
    out = _commit_round(0, rid=0, p=4, drafts=np.asarray([1, 2, 3]),
                        q_log=pi[:k], pi_log=pi, k_eff=k, temperature=0.0)
    assert out == [5]


def test_full_acceptance_commits_k_plus_bonus():
    v, k = 8, 3
    pi = np.full((k + 1, v), -10.0, np.float32)
    for j, t in enumerate([1, 2, 3, 4]):
        pi[j, t] = 10.0                  # argmax chain 1,2,3 then bonus 4
    out = _commit_round(0, rid=0, p=4, drafts=np.asarray([1, 2, 3]),
                        q_log=pi[:k], pi_log=torch.from_numpy(pi), k_eff=k,
                        temperature=0.0)
    assert out == [1, 2, 3, 4]


def test_k_eff_zero_commits_one_target_token():
    v = 8
    pi = np.full((4, v), -10.0, np.float32)
    pi[0, 6] = 10.0
    out = _commit_round(0, rid=0, p=4, drafts=np.asarray([1, 2, 3]),
                        q_log=pi[:3], pi_log=pi, k_eff=0, temperature=0.0)
    assert out == [6]


def test_sampling_round_is_keyed_by_token_index():
    """At temperature > 0 a round's draws depend on (base, rid, token
    index, purpose) alone: the same call gives the same tokens, another
    base or rid may not, and a certain proposal is always accepted."""
    v, k = 16, 3
    rng = np.random.default_rng(0)
    pi = torch.from_numpy(rng.standard_normal((k + 1, v)).astype(np.float32))
    q = pi[:k].clone()
    drafts = torch.argmax(pi[:k], -1).numpy()
    a = _commit_round(7, 1, 10, drafts, q, pi, k, 0.8)
    assert a == _commit_round(7, 1, 10, drafts, q, pi, k, 0.8)
    assert a[:k] == drafts.tolist()      # q == pi: ratio 1, all accepted
    outs = {tuple(_commit_round(b, r, 10, drafts, q, pi, k, 5.0))
            for b in range(4) for r in range(4)}
    assert len(outs) > 1


# ---------------------------------------------------------------------------
# generate parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,rate", KS_RATES)
def test_generate_greedy_parity(model, k, rate):
    jcfg, tcfg, jp, tp = model
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab, size=(2, 6))
    spec = dict(max_new_tokens=8, speculative=True, spec_k=k,
                draft_prune_rate=rate)
    base = generate(tp, tcfg, prompt, EngineConfig(max_new_tokens=8),
                    device="cpu")
    got = generate(tp, tcfg, prompt, EngineConfig(**spec), device="cpu")
    want = j_generate(jp, jcfg, jnp.asarray(prompt), JEngineConfig(**spec))
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_temperature_k_invariant(tiny):
    """With a perfect draft (prune rate 0) the committed stream at
    temperature > 0 is the same whatever spec_k is: every draw is keyed
    by its token index, never by the round."""
    _, tcfg, _, tp = tiny
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab, size=(2, 6))
    outs = [generate(tp, tcfg, prompt, EngineConfig(
        max_new_tokens=10, temperature=0.8, speculative=True, spec_k=k,
        draft_prune_rate=0.0), torch.Generator().manual_seed(7),
        device="cpu") for k in (1, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    other = generate(tp, tcfg, prompt, EngineConfig(
        max_new_tokens=10, temperature=0.8, speculative=True, spec_k=2,
        draft_prune_rate=0.0), torch.Generator().manual_seed(8),
        device="cpu")
    assert not torch.equal(other, outs[0])


# ---------------------------------------------------------------------------
# serve parity (acceptance)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,rate", KS_RATES)
def test_serve_spec_matches_plain_attn(model, k, rate):
    jcfg, tcfg, jp, tp = model
    trace = _trace(jcfg.vocab)
    plain = _serve(tp, tcfg, trace, **PAGED)
    spec = _serve(tp, tcfg, trace, **_spec(k, rate))
    want = _j_serve(jp, jcfg, trace, **_spec(k, rate))
    assert spec.tokens == plain.tokens == want.tokens
    assert set(spec.stats) == set(want.stats)
    for key, v in want.stats.items():
        if key not in _TIMED:
            assert spec.stats[key] == v, key
    st = spec.stats["speculative"]
    assert st["spec_k"] == k and st["rounds"] > 0
    if rate == 0.0:
        # perfect draft: every eligible proposal is accepted
        assert st["acceptance_rate"] == 1.0


def test_serve_spec_k1_degenerates_to_plain(tiny):
    _, tcfg, _, tp = tiny
    trace = _trace(tcfg.vocab, seed=9, n=4)
    plain = _serve(tp, tcfg, trace, **PAGED)
    spec = _serve(tp, tcfg, trace, **_spec(1, 0.0))
    assert spec.tokens == plain.tokens
    st = spec.stats["speculative"]
    assert st["acceptance_rate"] == 1.0
    assert st["proposed"] == st["accepted"]


def test_serve_spec_garbage_draft_still_exact(tiny):
    _, tcfg, _, tp = tiny
    trace = _trace(tcfg.vocab, seed=11, n=4)
    plain = _serve(tp, tcfg, trace, **PAGED)
    spec = _serve(tp, tcfg, trace, **_spec(4, 0.9))
    assert spec.tokens == plain.tokens
    assert spec.stats["speculative"]["acceptance_rate"] < 1.0


def test_serve_temperature_k_invariant(tiny):
    _, tcfg, _, tp = tiny
    trace = _trace(tcfg.vocab, seed=13)
    runs = [_serve(tp, tcfg, trace, torch.Generator().manual_seed(42),
                   **_spec(k, 0.0, temperature=0.8)).tokens
            for k in (1, 4)]
    assert runs[0] == runs[1]


def test_serve_spec_use_kernel_matches(tiny):
    """The verify step is multi-query, so ``use_kernel`` changes nothing
    (the draft runs the contiguous cache)."""
    _, tcfg, _, tp = tiny
    trace = _trace(tcfg.vocab, seed=15, n=4)
    a = _serve(tp, tcfg, trace, **_spec(3, 0.5))
    b = _serve(tp, tcfg, trace, **_spec(3, 0.5, use_kernel=True))
    assert a.tokens == b.tokens


# ---------------------------------------------------------------------------
# rollback: page-boundary acceptance must not corrupt or leak pages
# ---------------------------------------------------------------------------

def test_rollback_preserves_pool_invariants(tiny, monkeypatch):
    calls = []
    orig = PagePool.truncate

    def checked(self, slot, n_tokens):
        freed = orig(self, slot, n_tokens)
        self.check()
        calls.append(len(freed))
        return freed

    monkeypatch.setattr(PagePool, "truncate", checked)
    _, tcfg, _, tp = tiny
    trace = _trace(tcfg.vocab, seed=17, n=6)
    small = dict(n_slots=2, paged=True, page_size=2)
    plain = _serve(tp, tcfg, trace, **small)
    spec = _serve(tp, tcfg, trace, **_spec(5, 0.6, base=small))
    assert spec.tokens == plain.tokens
    assert calls, "speculative serve never truncated"
    assert sum(calls) > 0, "no rollback ever freed a page"


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------

def test_spec_serve_requires_paged(tiny):
    _, tcfg, _, tp = tiny
    with pytest.raises(ValueError, match="paged=True"):
        _serve(tp, tcfg, _trace(tcfg.vocab, n=2), n_slots=2,
               speculative=True)


def test_spec_rejects_stateful_mixer():
    hyb = t_configs.get_reduced("hymba-1.5b")
    assert hyb.mixer == "hybrid"
    with pytest.raises(NotImplementedError, match="per-position"):
        generate({}, dataclasses.replace(hyb, n_codebooks=0),
                 np.zeros((1, 6), np.int64),
                 EngineConfig(max_new_tokens=4, speculative=True),
                 device="cpu")


def test_spec_empty_requests(model):
    jcfg, tcfg, jp, tp = model
    res = _serve(tp, tcfg, [], **_spec(3, 0.5))
    want = _j_serve(jp, jcfg, [], **_spec(3, 0.5))
    assert res.tokens == {}
    assert res.stats["speculative"]["rounds"] == 0
    assert res.stats == want.stats
