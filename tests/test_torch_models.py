"""Port of models/config.py, configs/, models/layers.py and models/lm.py
(the paged serve subset): the same numpy-seeded inputs and the JAX
package's own parameters (through ``lm_params_from_numpy``) go through
both packages. Prefill logits and KV and ``decode_step_paged`` logits and
pools agree at 2e-5, the bound of tests/test_paged_attn.py's
``test_decode_step_kernel_matches_gather`` (fp32 summation order), for
reduced gemma-2b and that file's ``ATTN`` (n_kv=2) and ``WIN``
(window=6) configs, with the kernel path (its plain version on the CPU)
and the gather path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ModelConfig as JModelConfig
from repro.models import config as j_config
from repro.models import decode_step_paged as j_decode
from repro.models import init_paged_cache as j_cache
from repro.models import init_params as j_init
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.serve import PagePool as JPagePool
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (
    ModelConfig, config as t_config, decode_step_paged, init_paged_cache,
    init_params, layers as TL, prefill,
)
from repro_torch.serve import PagePool

ATTN = dict(name="tiny-pa-attn", mixer="attn", ffn="swiglu", n_layers=2,
            d_model=32, n_heads=4, n_kv=2, head_dim=16, d_ff=64, vocab=50,
            dtype="float32", logit_chunk=16, remat=False)
WIN = dict(ATTN, name="tiny-pa-win", window=6)
CFGS = {"gemma-2b-reduced": None, "attn": ATTN, "win": WIN}


def _cfgs(name):
    """The same configuration in both packages."""
    if CFGS[name] is None:
        return (j_configs.get_reduced("gemma-2b"),
                t_configs.get_reduced("gemma-2b"))
    return JModelConfig(**CFGS[name]), ModelConfig(**CFGS[name])


@pytest.fixture(scope="module", params=list(CFGS))
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _close(t, j, tol=2e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", j_configs.ARCH_IDS)
def test_registry_configs_equal_jax(arch):
    jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert dataclasses.asdict(t_configs.get_reduced(arch)) \
        == dataclasses.asdict(j_configs.get_reduced(arch))
    for shape in j_config.SHAPES:
        assert t_configs.cell_is_runnable(arch, shape) \
            == j_configs.cell_is_runnable(arch, shape)


def test_arch_ids_and_shapes_equal_jax():
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert t_config.SHAPES == {
        k: t_config.ShapeConfig(**dataclasses.asdict(v))
        for k, v in j_config.SHAPES.items()}
    assert t_config.SUBQUADRATIC == j_config.SUBQUADRATIC


def test_gemma_2b_parameter_count():
    cfg = t_configs.get_config("gemma-2b")
    assert cfg.param_count() == 3_030_460_416


# ---------------------------------------------------------------------------
# layer primitives
# ---------------------------------------------------------------------------

def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rmsnorm_matches_jax():
    x, s = _np(0, 3, 5, 64), _np(1, 64)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(s)), 1e-6)


@pytest.mark.parametrize("vector_pos", [False, True])
def test_apply_rope_matches_jax(vector_pos):
    x = _np(2, 2, 5, 3, 16)
    pos = (np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
           if vector_pos else np.arange(5, dtype=np.int32) + 9)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("chunks", [(512, 1024), (4, 8), (3, 5)])
def test_blockwise_attention_matches_jax(window, chunks):
    """Several query and key chunks with padding exercise the online
    rescaling; GQA with rep=2, Dv != D."""
    q, k, v = _np(3, 2, 13, 4, 8), _np(4, 2, 13, 2, 8), _np(5, 2, 13, 2, 6)
    qc, kc = chunks
    kw = dict(causal=True, window=window, q_chunk=qc, kv_chunk=kc)
    _close(TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw),
           JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw), 1e-5)


@pytest.mark.parametrize("ffn", ["swiglu", "geglu"])
def test_mlp_matches_jax(ffn):
    """geglu is jax.nn.gelu's tanh approximation, not torch's exact one."""
    cfg = JModelConfig(**dict(ATTN, ffn=ffn))
    jp = JL.mlp_init(jax.random.PRNGKey(3), cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _np(6, 2, 3, 32) * 3
    _close(TL.mlp_apply(tp, torch.from_numpy(x), ModelConfig(**dict(
        ATTN, ffn=ffn))), JL.mlp_apply(jp, jnp.asarray(x), cfg), 1e-5)


def test_paged_write_and_gather_match_jax():
    pool = _np(7, 9, 4, 2)
    table = np.asarray([[0, 1], [2, 3], [5, 6]], np.int32)
    pos = np.asarray([3, 4, 7], np.int32)
    new = _np(8, 3, 1, 2)
    want = JL.paged_write(jnp.asarray(pool), jnp.asarray(new),
                          jnp.asarray(pos), jnp.asarray(table))
    got = TL.paged_write(torch.from_numpy(pool.copy()),
                         torch.from_numpy(new), torch.from_numpy(pos),
                         torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        TL.paged_gather(got, torch.from_numpy(table)).numpy(),
        np.asarray(JL.paged_gather(want, jnp.asarray(table))))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_shapes_match_jax(model):
    _, jcfg, tcfg, jp, tp = model
    mine = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert len(mine["layers"]) == jcfg.n_layers
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        t = mine
        if keys[0] == "layers":
            t = mine["layers"][0]
            keys = keys[1:]
            shape = leaf.shape[1:]
        else:
            shape = leaf.shape
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == tuple(shape), keys
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


@pytest.mark.parametrize("mixer,ffn", [("mla", "swiglu"), ("ssd", "none"),
                                       ("hybrid", "swiglu"),
                                       ("attn", "moe")])
def test_other_mixers_and_ffns_raise(mixer, ffn):
    cfg = ModelConfig(**dict(ATTN, mixer=mixer, ffn=ffn))
    with pytest.raises(NotImplementedError, match="slice"):
        init_params(cfg, torch.Generator(), device="cpu")


@pytest.mark.parametrize("last_pos", [None, 7])
def test_prefill_matches_jax(model, last_pos):
    _, jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, size=(2, 13))
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                       last_pos=last_pos)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                     last_pos=last_pos)
    _close(tl, jl)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        _close(tc[k], jc[k])


def _paged_state(jcfg, tcfg, pos_list, psz=4, n_pages=10, max_pages=3):
    n_slots = len(pos_list)
    jpool = JPagePool(psz, n_pages, n_slots, max_pages)
    tpool = PagePool(psz, n_pages, n_slots, max_pages, device="cpu")
    for s, p in enumerate(pos_list):
        for pool in (jpool, tpool):
            pool.reserve(s, max_pages * psz)
            pool.ensure(s, int(p) + 1)
    np.testing.assert_array_equal(tpool.device_table().numpy(),
                                  np.asarray(jpool.device_table()))
    # non-trivial pool contents, so masked positions hold garbage
    rng = np.random.default_rng(11)
    shape = j_cache(jcfg, n_pages, psz, n_slots, jnp.float32)["k"].shape
    arrays = {k: rng.standard_normal(shape).astype(np.float32)
              for k in ("k", "v")}
    assert tuple(init_paged_cache(tcfg, n_pages, psz, n_slots,
                                  torch.float32, "cpu")["k"].shape) == shape
    return jpool, tpool, arrays


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
@pytest.mark.parametrize("vec", [False, True],
                         ids=["scalar-pos", "vector-pos"])
def test_decode_step_paged_matches_jax(model, use_kernel, vec):
    _, jcfg, tcfg, jp, tp = model
    pos_list = [7, 2, 10] if vec else [7, 7, 7]
    jpool, tpool, arrays = _paged_state(jcfg, tcfg, pos_list)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab, size=(3, 1))
    pos = np.asarray(pos_list, np.int32) if vec else 7
    jl, jc = j_decode(jp, {k: jnp.asarray(v) for k, v in arrays.items()},
                      jnp.asarray(toks), jnp.asarray(pos),
                      jpool.device_table(), jcfg, use_kernel=use_kernel)
    cache = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    tl, tc = decode_step_paged(tp, cache, torch.from_numpy(toks),
                               torch.as_tensor(pos), tpool.device_table(),
                               tcfg, use_kernel=use_kernel)
    assert tc is cache                         # pools updated in place
    assert tuple(tl.shape) == jl.shape
    _close(tl, jl)
    mapped = sorted({p for s in range(3) for p in tpool.slot_pages(s)})
    for k in ("k", "v"):                       # the pages slots own
        _close(tc[k][:, mapped], np.asarray(jc[k])[:, mapped])


def test_decode_step_kernel_matches_gather_in_port(model):
    _, jcfg, tcfg, _, tp = model
    _, tpool, arrays = _paged_state(jcfg, tcfg, [7, 2, 10])
    toks = torch.from_numpy(
        np.random.default_rng(13).integers(0, jcfg.vocab, size=(3, 1)))
    pos = torch.tensor([7, 2, 10], dtype=torch.int32)
    out = [decode_step_paged(
        tp, {k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
        toks, pos, tpool.device_table(), tcfg, use_kernel=uk)[0]
        for uk in (False, True)]
    _close(out[1], out[0].numpy())
