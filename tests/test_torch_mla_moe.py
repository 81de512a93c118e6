"""Port of models/layers.py's multi-head latent attention (MLA), with the
MLA and MoE branches of models/lm.py's init and convert.py's parameter
carry-over (tests/test_torch_moe.py holds ``moe_apply``).

The same numpy-seeded inputs and the JAX package's own parameters go
through both packages: ``mla_apply``, ``mla_decode`` (scalar and (B,)
pos) and ``mla_decode_paged`` (the kernel branch, whose kernel runs its
plain version on the CPU against JAX's Pallas kernel in interpret mode,
and the gather branch) agree at 2e-5 in fp32, the bound of
tests/test_paged_attn.py's kernel-vs-gather test, with slots at page
boundaries and an inactive slot on the scratch page; in bf16 at 1e-2,
the bf16 bound of the port's paged-attention tests.

XLA:CPU cannot run a bf16 x bf16 -> fp32 product (``einsum`` with
``preferred_element_type=F32``), eager or jitted, so the bf16 cases run
JAX's functions with such products' bf16 operands widened to fp32 first
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
from repro.models import init_params as j_init
from repro.models import layers as JL
from repro_torch import configs as t_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig, init_params
from repro_torch.models import layers as TL

TOL = 2e-5
BF16_TOL = 1e-2
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
            d_ff=128, vocab=97, dtype="float32", logit_chunk=16,
            remat=False)
# tests/test_models.py's and tests/test_paged_attn.py's MLA configs
MLA_MODELS = dict(name="mla", mixer="mla", ffn="swiglu", kv_lora=32,
                  q_lora=24, rope_head_dim=8, **BASE)
MLA_PAGED = dict(name="tiny-pa-mla", mixer="mla", ffn="swiglu",
                 n_layers=2, d_model=32, n_heads=2, n_kv=2, head_dim=16,
                 d_ff=64, vocab=50, kv_lora=16, q_lora=16, rope_head_dim=8,
                 dtype="float32", logit_chunk=16, remat=False)
MLA_CFGS = {"test-models-mla": MLA_MODELS, "test-paged-mla": MLA_PAGED,
            "deepseek-reduced": "deepseek-v2-236b"}


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
# MLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,window", [(n, None) for n in MLA_CFGS]
                         + [("deepseek-reduced", 5)])
def test_mla_apply_matches_jax(name, window):
    jcfg, tcfg, jp, tp = _layer(JL.mla_init, MLA_CFGS[name], 5)
    jx, tx = _x(1, (2, 11, jcfg.d_model), "float32")
    _close(TL.mla_apply(tp, tx, tcfg, window=window),
           _jit(JL.mla_apply, jp, jx, cfg=jcfg, window=window))


@pytest.mark.parametrize("vec", [False, True],
                         ids=["scalar-pos", "vector-pos"])
@pytest.mark.parametrize("s", [1, 3], ids=["one-query", "verify-3"])
def test_mla_decode_matches_jax(vec, s):
    jcfg, tcfg, jp, tp = _layer(JL.mla_init, MLA_MODELS, 6)
    b, t = 3, 12
    cache = {"c_kv": _np(2, b, t, jcfg.kv_lora),
             "k_rope": _np(3, b, t, jcfg.rope_head_dim)}
    pos = np.asarray([5, 0, 8], np.int32) if vec else 7
    jx, tx = _x(4, (b, s, jcfg.d_model), "float32")
    jo, jc = jax.jit(lambda p, x, c, q: JL.mla_decode(p, x, jcfg, c, q))(
        jp, jx, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    to, tc2 = TL.mla_decode(tp, tx, tcfg, tc, torch.as_tensor(pos))
    assert tc2["c_kv"] is tc["c_kv"]               # written in place
    _close(to, jo)
    for k in cache:
        _close(tc[k], jc[k])


def test_mla_cache_init_shapes_match_jax():
    jcfg, tcfg = _cfgs("deepseek-v2-236b")
    for j, t in ((JL.mla_cache_init(jcfg, 3, 10, jnp.float32),
                  TL.mla_cache_init(tcfg, 3, 10, torch.float32, "cpu")),
                 (JL.mla_paged_cache_init(jcfg, 9, 4, jnp.float32),
                  TL.mla_paged_cache_init(tcfg, 9, 4, torch.float32,
                                          "cpu"))):
        assert {k: tuple(v.shape) for k, v in t.items()} \
            == {k: v.shape for k, v in j.items()}


# (pos per slot, page table rows): psz 4, 8 pages + the scratch page 8
PAGED_CASES = {
    # the last offset of a page, the first of the next; slot 2 is
    # inactive, every entry naming the scratch page
    "page-boundaries-inactive-slot": (
        [3, 4, 0], [[0, 1, 2], [3, 4, 8], [8, 8, 8]]),
    # the last offset of the last page
    "scalar-pos": (11, [[0, 1, 2], [3, 4, 5], [6, 7, 8]]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["gather", "kernel"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_mla_decode_paged_matches_jax(case, use_kernel, dtype,
                                      _bf16_products_in_fp32):
    """JAX's kernel branch runs its Pallas kernel in interpret mode, the
    port's its plain version; both branches write the pools in place."""
    jcfg, tcfg, jp, tp = _layer(JL.mla_init, MLA_PAGED, 7, dtype=dtype)
    pos, table = PAGED_CASES[case]
    pool = {"c_kv": _np(8, 9, 4, jcfg.kv_lora),
            "k_rope": _np(9, 9, 4, jcfg.rope_head_dim)}
    jx, tx = _x(10, (3, 1, jcfg.d_model), dtype)
    jt = jnp.asarray(table, jnp.int32)
    # jitted, as the JAX engine runs it (XLA:CPU has no eager bf16 x
    # bf16 -> fp32 product)
    jo, jc = jax.jit(lambda p, x, c, q, t: JL.mla_decode_paged(
        p, x, jcfg, c, q, t, use_kernel=use_kernel))(
        jp, jx, {k: jnp.asarray(v).astype(dtype) for k, v in pool.items()},
        jnp.asarray(pos, jnp.int32), jt)
    tc = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in pool.items()}
    to, _ = TL.mla_decode_paged(tp, tx, tcfg, tc,
                                torch.as_tensor(pos, dtype=torch.int32),
                                torch.tensor(table, dtype=torch.int32),
                                use_kernel=use_kernel)
    tol = TOL if dtype == "float32" else BF16_TOL
    assert to.dtype == getattr(torch, dtype)
    _close(to, jo, tol)
    live = sorted({p for row in table for p in row if p != 8})
    for k in pool:
        _close(tc[k][live], np.asarray(jc[k].astype(jnp.float32))[live],
               tol)


def test_mla_kernel_branch_matches_gather_in_port():
    """The two branches of the port on the same pools: the kernel's
    plain version against the gather math at 2e-5 (fp32)."""
    _, tcfg, _, tp = _layer(JL.mla_init, "deepseek-v2-236b", 11)
    pos, table = PAGED_CASES["page-boundaries-inactive-slot"]
    pool = {"c_kv": _np(12, 9, 4, tcfg.kv_lora),
            "k_rope": _np(13, 9, 4, tcfg.rope_head_dim)}
    _, tx = _x(14, (3, 1, tcfg.d_model), "float32")
    out = [TL.mla_decode_paged(
        tp, tx, tcfg, {k: torch.from_numpy(v.copy()) for k, v in
                       pool.items()}, torch.tensor(pos, dtype=torch.int32),
        torch.tensor(table, dtype=torch.int32), use_kernel=uk)[0]
        for uk in (False, True)]
    _close(out[1], out[0].numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def test_mla_kernel_branch_launches_the_kernel_on_card(cuda_device):
    """On CUDA tensors the kernel branch launches B2 (no fallback) and
    agrees with the gather branch at 2e-5."""
    from repro_torch.kernels import paged_attn
    _, tcfg, _, tp = _layer(JL.mla_init, "deepseek-v2-236b", 11)
    tp = {k: v.to(cuda_device) for k, v in tp.items()}
    pos, table = PAGED_CASES["page-boundaries-inactive-slot"]
    pool = {"c_kv": _np(12, 9, 4, tcfg.kv_lora),
            "k_rope": _np(13, 9, 4, tcfg.rope_head_dim)}
    _, tx = _x(14, (3, 1, tcfg.d_model), "float32")
    out = []
    for uk in (False, True):
        before = paged_attn.LAUNCHES
        out.append(TL.mla_decode_paged(
            tp, tx.to(cuda_device), tcfg,
            {k: torch.from_numpy(v.copy()).to(cuda_device)
             for k, v in pool.items()},
            torch.tensor(pos, dtype=torch.int32, device=cuda_device),
            torch.tensor(table, dtype=torch.int32, device=cuda_device),
            use_kernel=uk)[0])
        torch.cuda.synchronize()
        assert paged_attn.LAUNCHES == before + (
            paged_attn.KERNELS_PER_CALL if uk else 0)
    _close(out[1].cpu(), out[0].cpu().numpy())


def test_mla_pools_have_no_kv_head_axis():
    """MLA's pools are (N, P, kvl) and (N, P, rd): the paged write and
    gather take them as they take attention's (N, P, KV, D)."""
    pool = _np(15, 9, 4, 6)
    table = np.asarray([[0, 1], [2, 8], [8, 8]], np.int32)
    pos = np.asarray([4, 3, 0], np.int32)
    new = _np(16, 3, 2, 6)
    want = JL.paged_write(jnp.asarray(pool), jnp.asarray(new),
                          jnp.asarray(pos), jnp.asarray(table))
    got = TL.paged_write(torch.from_numpy(pool.copy()),
                         torch.from_numpy(new), torch.from_numpy(pos),
                         torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy()[:8], np.asarray(want)[:8])
    np.testing.assert_array_equal(
        TL.paged_gather(got, torch.from_numpy(table)).numpy()[:2, :5],
        np.asarray(JL.paged_gather(want, jnp.asarray(table)))[:2, :5])


# ---------------------------------------------------------------------------
# init and convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_carry_across_with_shapes_and_dtypes(arch, dtype):
    """init_params' tree has JAX's shapes and dtypes per layer (fp32
    router in a bf16 model, 3-D expert stacks, nested shared experts),
    and lm_params_from_numpy carries JAX's values bit for bit."""
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    mine = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    carried = lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        m, c = mine, carried
        if keys[0] == "layers":
            m, c = mine["layers"][1], carried["layers"][1]
            keys, leaf = keys[1:], leaf[1]
        for k in keys:
            m, c = m[k], c[k]
        assert tuple(m.shape) == tuple(leaf.shape), keys
        assert str(m.dtype).split(".")[-1] == str(leaf.dtype), keys
        assert c.dtype == m.dtype
        np.testing.assert_array_equal(
            c.float().numpy(), np.asarray(leaf, np.float32))


def test_deepseek_layer_parameter_count():
    """One deepseek-v2-236b layer at full width, from the config: MLA
    149 M, routed experts 3.77 B, the two shared experts 47 M, router
    0.8 M; the cut depths the card phase runs."""
    cfg = t_configs.get_config("deepseek-v2-236b")
    one = dataclasses.replace(cfg, n_layers=1).param_count()
    emb = dataclasses.replace(cfg, n_layers=0).param_count()
    assert emb == 2 * cfg.vocab * cfg.d_model + cfg.d_model
    per_layer = one - emb
    assert round(per_layer / 1e9, 2) == 3.97
    assert 4 * dataclasses.replace(cfg, n_layers=2).param_count() < 37e9
    assert 2 * dataclasses.replace(cfg, n_layers=4).param_count() < 34e9
