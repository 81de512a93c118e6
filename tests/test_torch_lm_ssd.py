"""The SSD and hybrid branches of models/lm.py: init, prefill, the
contiguous and paged decode steps and both caches (nested for hybrid,
state leaves per slot), against the JAX package's own.

Reduced mamba2-370m (``ffn="none"``, fused in-projection) and
hymba-1.5b (split in-projections, attention + SSD heads), each also with
the MoE FFN, with JAX's ``PRNGKey(0)`` parameters carried across by
``lm_params_from_numpy``. Logits and every cache leaf agree at 2e-5 in
fp32, the port's prefill and decode bound (tests/test_torch_models.py),
inside the 2e-3 of tests/test_models.py::test_ssd_decode_matches_scan;
states stored in bf16 (``ssd_state_dtype``) and bf16 models at the
port's bf16 bound, 1e-2. The paged step runs hymba's attention through
the paged-attention kernel's plain version against JAX's Pallas kernel
in interpret mode, and through the gather path. JAX's functions are
compiled with ``xla_allow_excess_precision`` off, as in
tests/test_torch_ssd.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import decode_step as j_decode
from repro.models import decode_step_paged as j_decode_paged
from repro.models import init_cache as j_cache
from repro.models import init_paged_cache as j_paged_cache
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.serve import PagePool as JPagePool
from repro.serve.scheduler import grow_cache as j_grow
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (
    decode_step, decode_step_paged, init_cache, init_paged_cache,
    init_params, prefill,
)
from repro_torch.serve import PagePool
from repro_torch.serve.scheduler import grow_cache as t_grow

TOL = 2e-5
BF16_TOL = 1e-2
MOE = dict(ffn="moe", n_experts=4, top_k=2, moe_dff=64)
# (arch, overrides): reduced mamba2 and hymba, each also with the MoE FFN
MODELS = {"mamba2": ("mamba2-370m", {}),
          "hymba": ("hymba-1.5b", {}),
          "ssd-moe": ("mamba2-370m", MOE),
          "hybrid-moe": ("hymba-1.5b", MOE)}


def _cfgs(arch, **over):
    return (dataclasses.replace(j_configs.get_reduced(arch), **over),
            dataclasses.replace(t_configs.get_reduced(arch), **over))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _tol(t, tol=TOL):
    """The bound of a leaf: bf16-stored ones at the bf16 bound."""
    return max(tol, BF16_TOL) if t.dtype == torch.bfloat16 else tol


def _jit(fn, *args):
    """JAX's ``fn(*args)`` jitted, every op rounded to its type."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ---------------------------------------------------------------------------
# the model: init, prefill, and the decode steps
# ---------------------------------------------------------------------------

def _model(name, dtype="float32"):
    arch, over = MODELS[name]
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **over)
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    return _model(request.param)


def _leaf_pairs(tc, jc):
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, j in flat:
        t = tc
        for p in path:
            t = t[p.key]
        yield [p.key for p in path], t, j


def test_init_params_match_jax_layout(model):
    """The port's own init gives JAX's tree: ``ffn="none"`` has no
    norm2/ffn; SSD's a_log/d_skip/dt_bias are fp32."""
    jcfg, tcfg, jp, _ = model
    mine = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    layer = jax.tree.map(lambda a: a[0], jp["layers"])
    assert set(mine["layers"][0]) == set(layer)
    for keys, t, j in _leaf_pairs(mine["layers"][0], layer):
        assert tuple(t.shape) == j.shape, keys
        assert str(t.dtype).split(".")[-1] == str(j.dtype), keys


@pytest.mark.parametrize("s", [3, 21], ids=["3-tokens", "21-tokens"])
def test_prefill_matches_jax(model, s):
    """Logits and every cache leaf (the SSM state fp32, as JAX's prefill
    leaves it)."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(16).integers(0, jcfg.vocab, size=(2, s))
    jl, jc = _jit(lambda p, t: j_prefill(p, {"tokens": t}, jcfg), jp,
                  jnp.asarray(toks))
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(tl, jl)
    n = 0
    for keys, t, j in _leaf_pairs(tc, jc):
        assert tuple(t.shape) == j.shape, keys
        assert str(t.dtype).split(".")[-1] == str(j.dtype), keys
        _close(t, j)
        n += 1
    assert n == len(jax.tree.leaves(jc))


def _random_tree(tree, seed):
    """JAX's cache tree refilled with numpy-seeded values, each leaf in
    its own dtype."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), tree)


def _torch_tree(tree):
    return lm_params_from_numpy({"layers": jax.tree.map(
        lambda a: np.asarray(a)[None], tree)}, device="cpu")["layers"][0]


@pytest.mark.parametrize("vec", [False, True], ids=["scalar-pos",
                                                    "vector-pos"])
def test_decode_step_matches_jax(model, vec):
    """The contiguous decode step from a random cache (states in their
    dtypes), written in place."""
    jcfg, tcfg, jp, tp = model
    jc = _random_tree(j_cache(jcfg, 3, 12, jnp.float32), 17)
    tc = _torch_tree(jc)
    want_shapes = init_cache(tcfg, 3, 12, torch.float32, "cpu")
    for keys, t, j in _leaf_pairs(want_shapes, jc):
        assert tuple(t.shape) == j.shape and \
            str(t.dtype).split(".")[-1] == str(j.dtype), keys
    toks = np.random.default_rng(18).integers(0, jcfg.vocab, size=(3, 1))
    pos = np.asarray([7, 2, 10], np.int32) if vec else 7
    jl, jnew = _jit(lambda p, c, t, q: j_decode(p, c, t, q, jcfg), jp, jc,
                    jnp.asarray(toks), jnp.asarray(pos))
    tl, tnew = decode_step(tp, tc, torch.from_numpy(toks),
                           torch.as_tensor(pos), tcfg)
    assert tnew is tc
    _close(tl, jl)
    for keys, t, j in _leaf_pairs(tnew, jnew):
        _close(t, j, _tol(t))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_decode_step_paged_matches_jax(model, use_kernel):
    """The paged decode step from random pools and states; slots at
    page boundaries; the kernel path runs JAX's Pallas kernel in
    interpret mode and the port's plain version (hybrid only: SSD has no
    pool)."""
    jcfg, tcfg, jp, tp = model
    psz, n_pages, max_pages, pos_list = 4, 10, 3, [7, 2, 10]
    jpool = JPagePool(psz, n_pages, 3, max_pages)
    tpool = PagePool(psz, n_pages, 3, max_pages, device="cpu")
    for s, p in enumerate(pos_list):
        for pool in (jpool, tpool):
            pool.reserve(s, max_pages * psz)
            pool.ensure(s, p + 1)
    jc = _random_tree(j_paged_cache(jcfg, n_pages, psz, 3, jnp.float32), 19)
    tc = _torch_tree(jc)
    for keys, t, j in _leaf_pairs(
            init_paged_cache(tcfg, n_pages, psz, 3, torch.float32, "cpu"),
            jc):
        assert tuple(t.shape) == j.shape, keys
    toks = np.random.default_rng(20).integers(0, jcfg.vocab, size=(3, 1))
    pos = np.asarray(pos_list, np.int32)
    jl, jnew = _jit(lambda p, c, t, q, tab: j_decode_paged(
        p, c, t, q, tab, jcfg, use_kernel=use_kernel),
        jp, jc, jnp.asarray(toks), jnp.asarray(pos), jpool.device_table())
    tl, tnew = decode_step_paged(tp, tc, torch.from_numpy(toks),
                                 torch.from_numpy(pos), tpool.device_table(),
                                 tcfg, use_kernel=use_kernel)
    assert tnew is tc
    _close(tl, jl)
    mapped = sorted({p for s in range(3) for p in tpool.slot_pages(s)})
    for keys, t, j in _leaf_pairs(tnew, jnew):
        if keys[-1] in ("k", "v"):
            t, j = t[:, mapped], np.asarray(j)[:, mapped]
        _close(t, j, _tol(t))


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_bf16_prefill_and_decode_match_jax(arch):
    """bf16 weights: prefill logits and caches, then one contiguous
    decode step from the prefill's cache, at the port's bf16 bound."""
    jcfg, tcfg, jp, tp = _model("mamba2" if arch.startswith("mamba")
                                else "hymba", "bfloat16")
    toks = np.random.default_rng(21).integers(0, jcfg.vocab, size=(2, 19))
    jl, jc = _jit(lambda p, t: j_prefill(p, {"tokens": t}, jcfg), jp,
                  jnp.asarray(toks))
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(tl, jl, BF16_TOL)
    for keys, t, j in _leaf_pairs(tc, jc):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), keys
        _close(t, j, BF16_TOL)
    jc, tc = j_grow(jc, 4), t_grow(tc, 4)
    nxt = np.argmax(np.asarray(jl), -1)[:, None]
    jl2, _ = _jit(lambda p, c, t: j_decode(p, c, t, 19, jcfg), jp, jc,
                  jnp.asarray(nxt))
    tl2, _ = decode_step(tp, tc, torch.from_numpy(nxt), 19, tcfg)
    _close(tl2, jl2, BF16_TOL)
