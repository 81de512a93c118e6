"""Port of models/layers.py's mixture of experts (MoE): ``moe_init`` and
``moe_apply``.

The same numpy-seeded inputs and the JAX package's own parameters go
through both packages. ``moe_apply`` at reduced deepseek-v2-236b (top-6
of 160 at full width; top-2 of 4 here, one shared expert), reduced
llama4-scout (top-1, one shared expert) and tests/test_models.py's MoE
config agrees at 2e-5 (the port's fp32 bound), over one chunk, a padded
last chunk and several chunks. Every token keeps exactly the experts JAX
keeps, read through each package's own gradient with respect to the
expert weights: with capacity forced down so that assignments drop, and
with tied router rows, where both take the lower expert index first.

XLA:CPU cannot run a bf16 x bf16 -> fp32 product (``einsum`` with
``preferred_element_type=F32``), eager or jitted, so the bf16 case runs
JAX's function with such products' bf16 operands widened to fp32 first
(``_bf16_products_in_fp32``). A product of two bf16 values is exact in
fp32, so this is the same function; only the summation order is the
backend's, as it is on any other backend."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import ModelConfig as JModelConfig
from repro.models import layers as JL
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig
from repro_torch.models import layers as TL

TOL = 2e-5
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
            d_ff=128, vocab=97, dtype="float32", logit_chunk=16,
            remat=False)
# tests/test_models.py's MoE config
MOE_MODELS = dict(name="moe", mixer="attn", ffn="moe", n_experts=4,
                  top_k=2, n_shared=0, moe_dff=32, moe_chunk=32,
                  capacity_factor=2.0, **BASE)
MOE_CFGS = {"deepseek-reduced": "deepseek-v2-236b",
            "llama4-scout-reduced": "llama4-scout-17b-a16e",
            "test-models-moe": MOE_MODELS}


def _cfgs(spec, **over):
    """The same configuration in both packages."""
    if isinstance(spec, str):
        jc, tc = j_configs.get_reduced(spec), t_configs.get_reduced(spec)
    else:
        jc, tc = JModelConfig(**spec), ModelConfig(**spec)
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _carry(tree):
    """One layer's JAX parameter dict -> the port's, through the public
    converter (bf16 keeps its bits)."""
    stacked = jax.tree.map(lambda a: np.asarray(a)[None], tree)
    return lm_params_from_numpy({"layers": stacked}, device="cpu")[
        "layers"][0]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _layer(init, spec, seed, dtype="float32", **over):
    jcfg, tcfg = _cfgs(spec, dtype=dtype, **over)
    jp = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _carry(jp)


def _jit(fn, *args, **static):
    """JAX's ``fn(*args, **static)`` jitted, as its engine runs it."""
    return jax.jit(functools.partial(fn, **static))(*args)


_einsum = jnp.einsum


def _widened_einsum(subscripts, *operands, preferred_element_type=None,
                    **kw):
    if preferred_element_type == jnp.float32:
        operands = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                    for o in operands]
    return _einsum(subscripts, *operands,
                   preferred_element_type=preferred_element_type, **kw)


@pytest.fixture
def _bf16_products_in_fp32(monkeypatch):
    monkeypatch.setattr(jnp, "einsum", _widened_einsum)


def _x(seed, shape, dtype):
    x = _np(seed, *shape)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 5), (2, 40), (3, 16)],
                         ids=["5-tokens", "80-tokens-padded-chunk",
                              "48-tokens"])
@pytest.mark.parametrize("name", list(MOE_CFGS))
def test_moe_apply_matches_jax(name, shape):
    jcfg, tcfg, jp, tp = _layer(JL.moe_init, MOE_CFGS[name], 7)
    jx, tx = _x(17, shape + (jcfg.d_model,), "float32")
    _close(TL.moe_apply(tp, tx * 3, tcfg),
           _jit(JL.moe_apply, jp, jx * 3, cfg=jcfg))


def test_moe_apply_bf16_matches_jax(_bf16_products_in_fp32):
    jcfg, tcfg, jp, tp = _layer(JL.moe_init, "deepseek-v2-236b", 8,
                                dtype="bfloat16")
    assert tp["router"].dtype == torch.float32
    assert tp["w_gate"].dtype == torch.bfloat16
    jx, tx = _x(18, (2, 12, jcfg.d_model), "bfloat16")
    got = TL.moe_apply(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    want = _jit(JL.moe_apply, jp, jx, cfg=jcfg).astype(jnp.float32)
    # the routed and the shared experts' outputs are each rounded to
    # bf16, then added: a one-ulp flip in an addend (2^-7 of its size,
    # fp32 summation order) stays one ulp of that addend in the sum,
    # however small the sum; two ulps of the largest output bound it
    _close(got, want, 2 * 2 ** -7 * float(jnp.abs(want).max()))


def _tie_all(p):
    return {**p, "router": p["router"] * 0}


def _tie_pair(p):
    """Experts 1 and 3 score 0 for every token: tied with each other."""
    r = np.array(p["router"])
    r[:, 1] = r[:, 3] = 0.0
    return {**p, "router": jnp.asarray(r)}


# name -> (config, capacity_factor, router edit, whether some assignment
# must drop: None where either is allowed)
KEEP_CASES = {
    "deepseek-forced-drops": ("deepseek-v2-236b", 0.25, None, True),
    "llama4-forced-drops": ("llama4-scout-17b-a16e", 0.25, None, True),
    "deepseek-tied-rows": ("deepseek-v2-236b", 1.25, _tie_all, True),
    "deepseek-tied-pair": ("deepseek-v2-236b", 1.25, _tie_pair, None),
    "llama4-tied-rows": ("llama4-scout-17b-a16e", 1.25, _tie_all, True),
}


def _j_kept(jp, jx, jcfg):
    """JAX's kept (token, expert) pairs: where d y[token] / d w_down[e]
    is nonzero."""
    n = jx.shape[0] * jx.shape[1]

    def y_t(w, t):
        y = JL.moe_apply({**jp, "w_down": w}, jx, jcfg)
        return y.reshape(n, -1)[t].sum()

    g = jax.jit(jax.vmap(lambda t: jax.grad(y_t)(jp["w_down"], t)))(
        jnp.arange(n))
    return np.asarray(jnp.abs(g).sum(axis=(2, 3)) > 0)


def _t_kept(tp, tx, tcfg):
    n = tx.shape[0] * tx.shape[1]
    w = tp["w_down"].clone().requires_grad_(True)
    y = TL.moe_apply({**tp, "w_down": w}, tx, tcfg).reshape(n, -1)
    out = []
    for t in range(n):
        (g,) = torch.autograd.grad(y[t].sum(), w, retain_graph=True)
        out.append((g.abs().sum(dim=(1, 2)) > 0).numpy())
    return np.stack(out)


@pytest.mark.parametrize("case", list(KEEP_CASES))
def test_moe_kept_experts_equal_jax(case):
    spec, cf, edit, drops = KEEP_CASES[case]
    jcfg, tcfg, jp, _ = _layer(JL.moe_init, spec, 9, capacity_factor=cf,
                               moe_chunk=16)
    if edit is not None:
        jp = edit(jp)
    tp = _carry(jp)
    jx, tx = _x(19, (2, 12, jcfg.d_model), "float32")
    want = _j_kept(jp, jx, jcfg)
    got = _t_kept(tp, tx, tcfg)
    np.testing.assert_array_equal(got, want)
    kept = want.sum(axis=1)
    assert kept.max() <= jcfg.top_k
    assert drops is None or (kept.min() < jcfg.top_k) == drops
    _close(TL.moe_apply(tp, tx, tcfg), _jit(JL.moe_apply, jp, jx,
                                             cfg=jcfg))


def test_top_k_takes_the_lower_index_first_on_ties():
    rows = np.asarray([[0.1, 0.3, 0.3, 0.3], [0.25] * 4,
                       [0.4, 0.1, 0.4, 0.1], [0.2, 0.2, 0.5, 0.1]],
                      np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = TL._top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_capacity_follows_the_chunk():
    """Tokens in one chunk compete for capacity, so a token's output
    depends on its batch (in JAX as here): one chunk of two rows against
    each row alone."""
    jcfg, tcfg, jp, tp = _layer(JL.moe_init, "deepseek-v2-236b", 10,
                                capacity_factor=0.25)
    jx, tx = _x(20, (2, 24, jcfg.d_model), "float32")
    together = TL.moe_apply(tp, tx, tcfg)
    alone = torch.cat([TL.moe_apply(tp, tx[i:i + 1], tcfg)
                       for i in range(2)])
    _close(together, _jit(JL.moe_apply, jp, jx, cfg=jcfg))
    _close(alone, jnp.concatenate([_jit(JL.moe_apply, jp, jx[i:i + 1],
                                        cfg=jcfg) for i in range(2)]))
    assert not torch.allclose(together, alone)
