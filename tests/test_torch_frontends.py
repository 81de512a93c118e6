"""The modality frontends of models/lm.py against the JAX package's:
musicgen-medium's codebooks (a (K, V, d) embedding summed over the K
codebooks, a (d, K*V) head, logits (B, K, V) and (B, 1, K, V)) and
internvl2-2b's image tokens (``img_embeds`` projected by ``img_proj``
and put before the text), and ``generate``'s codebook path.

Reduced configs, JAX's ``PRNGKey(0)`` parameters carried across by
``lm_params_from_numpy``, inputs from numpy seeds. Logits agree at 2e-5
in fp32 (the port's prefill and decode bound, tests/test_torch_models.py)
and greedy tokens are equal. The bf16 codebook sum is bit-equal to JAX's
compiled with ``xla_allow_excess_precision`` off (XLA otherwise keeps the
running sum wider than bf16 inside the fusion). What neither package
serves raises in both: an image-token model on every engine path (they
prefill token ids alone, with no ``img_embeds``), a codebook model on
every path but ``generate``."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
from repro import configs as j_configs
from repro.models import lm as JL
from repro.serve.scheduler import grow_cache as j_grow
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import lm as TL
from repro_torch.serve import (
    EngineConfig, PagePool, Request, generate, serve_continuous,
    serve_disaggregated,
)
from repro_torch.serve.scheduler import grow_cache as t_grow

TOL = 2e-5
ARCHS = ("musicgen-medium", "internvl2-2b")


def _cfgs(arch, **over):
    return (dataclasses.replace(j_configs.get_reduced(arch), **over),
            dataclasses.replace(t_configs.get_reduced(arch), **over))


def _model(arch, **over):
    jcfg, tcfg = _cfgs(arch, **over)
    jp = jax.jit(JL.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def musicgen():
    return _model("musicgen-medium")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _jit(fn, *args):
    """JAX's ``fn(*args)`` jitted, every op rounded to its type."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _batch(cfg, b, s, seed=0, labels=False):
    """Numpy inputs: (B, S) or (B, S, K) ids, stub image embeddings."""
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=shape)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, 1024)).astype(np.float32)
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, size=(b, s))
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_jax(arch):
    """The port's own init gives JAX's tree: (K, V, d) codebook
    embeddings and a (d, K*V) head; img_proj (1024, d)."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.eval_shape(lambda: JL.init_params(jax.random.PRNGKey(0), jcfg))
    mine = TL.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert set(mine) == set(jp)
    for k in set(jp) - {"layers"}:
        assert tuple(mine[k].shape) == jp[k].shape, k
        assert str(mine[k].dtype).split(".")[-1] == str(jp[k].dtype), k
    d = tcfg.d_model
    if tcfg.n_codebooks:
        assert tuple(mine["embed"].shape) == (tcfg.n_codebooks,
                                              tcfg.vocab, d)
        assert tuple(mine["head"].shape) == (d, tcfg.n_codebooks
                                             * tcfg.vocab)
    else:
        assert tuple(mine["img_proj"].shape) == (1024, d)


def test_carry_over_keeps_the_frontend_weights(model):
    _, _, jp, tp = model
    for k in ("embed", "head", "img_proj"):
        if k in jp:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k


# ---------------------------------------------------------------------------
# embeddings and inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codebook_sum_matches_jax(dtype):
    """The K codebook embeddings summed in JAX's order and rounding:
    bit-equal, bf16 included."""
    jcfg, tcfg, jp, tp = _model("musicgen-medium", dtype=dtype)
    toks = _batch(jcfg, 3, 7, seed=1)["tokens"]
    want = _jit(partial(JL.embed_tokens, cfg=jcfg), jp, jnp.asarray(toks))
    got = TL.embed_tokens(tp, torch.as_tensor(toks), tcfg)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assemble_inputs_matches_jax(dtype):
    """Image embeddings cast to the model dtype, projected, put before
    the text; the labels padded with -1 for the image positions."""
    jcfg, tcfg, jp, tp = _model("internvl2-2b", dtype=dtype)
    batch = _batch(jcfg, 2, 5, seed=2, labels=True)
    jx, jl = _jit(partial(JL.assemble_inputs, cfg=jcfg), jp, _j(batch))
    tx, tl = TL.assemble_inputs(tp, _t(batch), tcfg)
    n = jcfg.n_img_tokens
    assert tuple(tx.shape) == jx.shape == (2, n + 5, jcfg.d_model)
    assert str(tx.dtype).split(".")[-1] == dtype
    _close(tx, jx, TOL if dtype == "float32" else 1e-2)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert (tl[:, :n] == -1).all()


# ---------------------------------------------------------------------------
# prefill and the decode steps
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_jax(model):
    """Prefill logits ((B, K, V) for codebooks), the cache (text after
    the image tokens), then three contiguous decode steps
    ((B, 1, K, V))."""
    jcfg, tcfg, jp, tp = model
    b, s = 2, 6
    batch = _batch(jcfg, b, s, seed=3)
    jl, jc = jax.jit(partial(JL.prefill, cfg=jcfg))(jp, _j(batch))
    with torch.no_grad():
        tl, tc = TL.prefill(tp, _t(batch), tcfg)
    k = jcfg.n_codebooks
    assert tuple(tl.shape) == jl.shape == (
        (b, k, jcfg.vocab) if k else (b, jcfg.padded_vocab))
    _close(tl, jl)
    t0 = s + jcfg.n_img_tokens
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].shape[2] == t0
        _close(tc[key], jc[key])
    jc, tc = j_grow(jc, 3), t_grow(tc, 3)
    step = jax.jit(partial(JL.decode_step, cfg=jcfg))
    rng = np.random.default_rng(4)
    for i in range(3):
        shape = (b, 1, k) if k else (b, 1)
        toks = rng.integers(0, jcfg.vocab, size=shape)
        jl, jc = step(jp, jc, jnp.asarray(toks), jnp.asarray(t0 + i))
        with torch.no_grad():
            tl, tc = TL.decode_step(tp, tc, torch.as_tensor(toks), t0 + i,
                                    tcfg)
        assert tuple(tl.shape) == jl.shape == (
            (b, 1, k, jcfg.vocab) if k else (b, 1, jcfg.padded_vocab))
        _close(tl, jl)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_paged_step_with_codebooks_matches_jax(musicgen, use_kernel):
    """The paged decode step of a codebook model: logits (B, 1, K*V),
    unmasked and unreshaped, as JAX leaves them (the kernel runs its
    plain version here, JAX's Pallas kernel in interpret mode)."""
    jcfg, tcfg, jp, tp = musicgen
    psz, n_slots, max_pages = 4, 3, 3
    pos = np.array([5, 0, 9], np.int32)
    pool = PagePool(psz, n_slots * max_pages, n_slots, max_pages,
                    device="cpu")
    jpool = J.PagePool(psz, n_slots * max_pages, n_slots, max_pages)
    for i, p in enumerate(pos):
        for pl in (pool, jpool):
            pl.reserve(i, int(p) + 1)
            pl.ensure(i, int(p) + 1)
    rng = np.random.default_rng(5)
    jcache = JL.init_paged_cache(jcfg, pool.n_pages, psz, n_slots,
                                 jnp.float32)
    jcache = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jcache)
    tcache = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jcache)
    toks = rng.integers(0, jcfg.vocab, size=(n_slots, 1, jcfg.n_codebooks))
    jl, _ = JL.decode_step_paged(jp, jcache, jnp.asarray(toks),
                                 jnp.asarray(pos), jpool.device_table(),
                                 jcfg, use_kernel=use_kernel)
    with torch.no_grad():
        tl, _ = TL.decode_step_paged(tp, tcache, torch.as_tensor(toks),
                                     torch.as_tensor(pos),
                                     pool.device_table(), tcfg,
                                     use_kernel=use_kernel)
    assert tuple(tl.shape) == jl.shape == (
        n_slots, 1, jcfg.n_codebooks * jcfg.vocab)
    _close(tl, jl)


def test_prefill_partial_with_codebooks_matches_jax(musicgen):
    """No serve path runs it for codebooks; it computes what JAX's does:
    (B, K*V) logits with every column past the vocab masked."""
    jcfg, tcfg, jp, tp = musicgen
    rng = np.random.default_rng(6)
    start, s, c = 4, 3, 8
    ctx = {k: rng.standard_normal(
        (jcfg.n_layers, 1, c, jcfg.n_kv, jcfg.hd)).astype(np.float32)
        for k in ("k", "v")}
    toks = rng.integers(0, jcfg.vocab, size=(1, s, jcfg.n_codebooks))
    jl, jc = JL.prefill_partial(jp, {"tokens": jnp.asarray(toks)},
                                _j(ctx), jcfg, start=start)
    with torch.no_grad():
        tl, tc = TL.prefill_partial(tp, {"tokens": torch.as_tensor(toks)},
                                    _t(ctx), tcfg, start=start)
    assert tuple(tl.shape) == jl.shape == (1, jcfg.n_codebooks * jcfg.vocab)
    assert (tl[:, jcfg.vocab:] == -1e30).all()
    _close(tl, jl)
    _close(tc["k"], jc["k"])


# ---------------------------------------------------------------------------
# generate and the serve paths
# ---------------------------------------------------------------------------

def test_musicgen_generate_matches_jax(musicgen):
    """Greedy ``generate`` over 4 codebooks: (B, S + new, K), the tokens
    JAX's give."""
    jcfg, tcfg, jp, tp = musicgen
    prompt = _batch(jcfg, 2, 5, seed=7)["tokens"]
    cfg = dict(max_new_tokens=6)
    want = np.asarray(J.generate(jp, jcfg, prompt, J.EngineConfig(**cfg)))
    got = generate(tp, tcfg, prompt, EngineConfig(**cfg), device="cpu")
    assert tuple(got.shape) == want.shape == (2, 11, jcfg.n_codebooks)
    assert np.array_equal(got.numpy(), want)


def test_musicgen_generate_samples_each_codebook(musicgen):
    """At temperature > 0 every codebook draws its own token from the
    generator: valid ids, reproducible from the seed."""
    _, tcfg, _, tp = musicgen
    prompt = _batch(tcfg, 2, 5, seed=8)["tokens"]
    cfg = EngineConfig(max_new_tokens=5, temperature=0.9)

    def run(seed):
        return generate(tp, tcfg, prompt, cfg, device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    a = run(3)
    assert tuple(a.shape) == (2, 10, tcfg.n_codebooks)
    assert torch.equal(a, run(3))
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab
    assert torch.equal(a[:, :5], torch.as_tensor(prompt))


def _reqs(cfg, make):
    rng = np.random.default_rng(9)
    shape = (4, cfg.n_codebooks) if cfg.n_codebooks else (4,)
    return [make(rid=0, tokens=rng.integers(0, cfg.vocab, size=shape),
                 max_new_tokens=2)]


PAGED = dict(n_slots=2, paged=True, page_size=4)
RAISES = {
    # path: (JAX's call, the port's, the port's message)
    "generate": (
        lambda p, c, r: J.generate(p, c, np.stack([r[0].tokens]),
                                   J.EngineConfig(max_new_tokens=2)),
        lambda p, c, r: generate(p, c, np.stack([r[0].tokens]),
                                 EngineConfig(max_new_tokens=2),
                                 device="cpu")),
    "serve_continuous": (
        lambda p, c, r: J.serve_continuous(p, c, r,
                                           J.EngineConfig(**PAGED)),
        lambda p, c, r: serve_continuous(p, c, r, EngineConfig(**PAGED),
                                         device="cpu")),
    "serve_disaggregated": (
        lambda p, c, r: J.serve_disaggregated(p, c, r,
                                              J.EngineConfig(**PAGED)),
        lambda p, c, r: serve_disaggregated(p, c, r, EngineConfig(**PAGED),
                                            device="cpu")),
    "speculative": (
        lambda p, c, r: J.generate(p, c, np.stack([r[0].tokens]),
                                   J.EngineConfig(max_new_tokens=2,
                                                  speculative=True)),
        lambda p, c, r: generate(p, c, np.stack([r[0].tokens]),
                                 EngineConfig(max_new_tokens=2,
                                              speculative=True),
                                 device="cpu")),
}
CASES = [("musicgen-medium", p) for p in
         ("serve_continuous", "serve_disaggregated", "speculative")] + [
    ("internvl2-2b", p) for p in RAISES]


@pytest.mark.parametrize("arch,path", CASES)
def test_unserved_frontend_paths_raise_in_both_packages(arch, path):
    """JAX fails on the missing ``img_embeds`` key (its engines prefill
    token ids alone) and refuses codebooks outside ``generate``; the
    port raises on both, and says why."""
    jcfg, tcfg, jp, tp = _model(arch)
    j_call, t_call = RAISES[path]
    if tcfg.n_img_tokens:
        with pytest.raises(KeyError, match="img_embeds"):
            j_call(jp, jcfg, _reqs(jcfg, J.Request))
        match = "img_embeds"
    else:
        with pytest.raises(NotImplementedError):
            j_call(jp, jcfg, _reqs(jcfg, J.Request))
        match = "single-stream"
    with pytest.raises(NotImplementedError, match=match):
        t_call(tp, tcfg, _reqs(tcfg, Request))
